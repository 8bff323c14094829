"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, in ``build/``
at the repository root (listed in ``.gitignore``).  The library's name
carries a hash of the source, of every ``csrc/*.cuh`` header it includes
(``#include "..."``, followed through headers) and of the flags, so an
edited source or header is rebuilt and a built one is reused.
``build_all`` runs ``build`` for several sources (by default every one of
:data:`SOURCES`) on threads, so their ``nvcc`` runs overlap.  ``build`` is safe to call from several threads at
once (the compound runtime's section workers do): one lock per source
name lets one thread compile and load it while the others wait for that
``Built``.  :func:`count_launch` bumps a wrapper's launch counter exactly
under threads.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
#: the port's kernel sources, ``csrc/<name>.cu``
SOURCES = ("flash_fwd", "flash_bwd", "distill_kl_fwd", "distill_kl_bwd",
           "ssd_fwd", "ssd_bwd")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float          # 0.0 when an earlier build was reused
    log: str                # nvcc's output (ptxas registers/spills)


_LOADED: dict[str, Built] = {}
_LOCKS: dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _key_sources(src: Path) -> list[Path]:
    """``src`` and the ``csrc`` headers it includes, directly or through
    another header, each once, in the order first met."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / name for name in _INCLUDE.findall(path.read_text())
                 if (CSRC / name).is_file()]
    return seen


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def count_launch(fn) -> None:
    """``fn.launches += 1`` as one step under threads: a kernel wrapper
    calls it where it launches its kernel."""
    with _COUNT_LOCK:
        fn.launches += 1


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` (once per process) and load it."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LOADED:
            _LOADED[name] = _build(name)
        return _LOADED[name]


def _build(name: str) -> Built:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _key_sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}_{digest}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
    return Built(ctypes.CDLL(str(out)), out, seconds,
                 log_path.read_text() if log_path.exists() else "")


def build_all(names=SOURCES) -> dict[str, Built]:
    """``build`` each name on a thread of its own, so each source's ``nvcc``
    starts at once; raises the first failure after all have ended."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))
