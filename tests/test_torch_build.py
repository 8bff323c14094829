"""The kernel builder (``repro_torch.kernels._build``) with a stand-in
``nvcc`` that links an empty shared library: every source starts its own
compiler at once, a built library is reused, an edited header rebuilds
the sources that include it, and a failed build raises with the
compiler's output."""
import os
import shutil
import stat

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: note the start, fail on request, link an empty library
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo start >> "$STARTS"
case "$*" in *broken*) echo "error: broken source" ; exit 2 ;; esac
echo "ptxas info    : Used 42 registers"
exec gcc -shared -fPIC -o "$out" -x c /dev/null
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    if shutil.which("gcc") is None:
        pytest.skip("no gcc to link a stand-in library")
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b", "broken"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}"
                       f"{os.environ['PATH']}")
    monkeypatch.setenv("STARTS", str(tmp_path / "starts"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    return tmp_path


def test_build_all_builds_each_source_once_and_reuses_it(fake):
    built = _build.build_all(["a", "b"])
    assert set(built) == {"a", "b"}
    assert all("42 registers" in b.log for b in built.values())
    assert all(b.seconds > 0 for b in built.values())
    assert (fake / "starts").read_text().count("start") == 2
    assert _build.build("a") is built["a"]
    _build._LOADED.clear()                  # a new process: the .so is kept
    again = _build.build("b")
    assert again.seconds == 0.0 and again.path == built["b"].path
    assert (fake / "starts").read_text().count("start") == 2


def test_build_failure_raises_with_the_compiler_output(fake):
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build_all(["a", "broken"])
    assert not list((fake / "build").glob("broken_*.so"))


def test_editing_a_header_rebuilds_the_sources_that_include_it(fake):
    csrc = fake / "csrc"
    (csrc / "prims.cuh").write_text("// v1\n")
    (csrc / "wrap.cuh").write_text('#include "prims.cuh"\n')
    (csrc / "a.cu").write_text('#include "wrap.cuh"\n#include <cstdint>\n')
    first = _build.build_all(["a", "b"])
    _build._LOADED.clear()
    (csrc / "prims.cuh").write_text("// v2\n")   # included through wrap.cuh
    again = _build.build_all(["a", "b"])
    assert again["a"].seconds > 0 and again["a"].path != first["a"].path
    assert again["b"].seconds == 0.0 and again["b"].path == first["b"].path
    assert (fake / "starts").read_text().count("start") == 3


def test_build_and_launch_counts_are_exact_under_threads(tmp_path,
                                                         monkeypatch):
    """Section workers call a kernel for the first time from several
    threads at once: the compiler must run once for a name, every thread
    must get the same ``Built``, and a launch counter bumped from every
    thread must come out exact."""
    import ctypes
    import subprocess
    import sys
    import threading
    import time
    from types import SimpleNamespace

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_LOCKS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    runs = []

    def fake_run(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.05)                  # widen the window a race needs
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("lib")
        return SimpleNamespace(returncode=0, stdout="ok", stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: SimpleNamespace(
        path=path))
    got, errors = [None] * 8, []
    start = threading.Barrier(8)

    def worker(i):
        try:
            start.wait(timeout=10)
            got[i] = _build.build("k")
        except Exception as e:            # reported by the assert below
            errors.append(e)

    def counting(fn):
        start.wait(timeout=10)
        for _ in range(5000):
            _build.count_launch(fn)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)

        def kernel():
            pass
        kernel.launches = 0
        threads = [threading.Thread(target=counting, args=(kernel,))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(runs) == 1
    assert all(b is got[0] for b in got) and got[0].seconds > 0
    assert kernel.launches == 8 * 5000
