"""The SSD backward's kernels against another tree's, on one card.

Builds ``src/repro_torch/kernels/csrc/ssd_bwd.cu`` of this tree (through
``kernels._build``) and of another tree (``--base DIR``: a checkout of an
earlier commit, unpacked from ``git archive``) with the same ``nvcc``
flags, and calls each through its own C entry point in turns inside one
process (an entry point without the ``tma`` argument, the CUDA-core kernel
of earlier trees, gets that kernel's scratch sizes):

* bf16, x, B and C sliced from one tensor as the model passes them, at
  mamba2-130m's training shape (``chip_smoke.SSD_MAIN``) and at each shape
  of ``chip_smoke.py``'s backward sweep (``SSD_BWD_SWEEP``): base, this,
  this, base, CUDA events over 10 calls a turn, then the same turns traced
  (``torch.profiler``, 5 calls a turn), each build's kernels apart; and how
  far this tree's outputs lie from the base's: dx, dB and dC row by row
  (``chip_smoke.row_rel_err``), ddt, dA and dD against the leaf's largest
  element;
* with ``--variants FILE``, more builds in the same turns: each a copy of
  this tree's ``ssd_bwd.cu`` and ``hopper.cuh`` with the text replacements
  FILE lists, a JSON object ``{"name": [[file, old, new, count], ...]}``
  (``old`` must occur ``count`` times in ``file``);
* with ``--steps``, warm training steps of mamba2-130m (``chip_smoke``'s
  ``lm_train_setup`` at 4 x 4096, bf16; 3 a turn after one unmeasured) with
  the model's SSD backward (``ssd_scan.ssd_bwd``, which ``ops.ssd_scan``
  hands to autograd) routed to one build or the other, base, this, this,
  base, then one traced step a build: wall, device busy and the SSD
  backward's kernels.

Run from the repository root on a machine with the card::

    mkdir -p build/base && git archive HEAD | tar -x -C build/base
    python3 tools/ssd_bwd_ab.py --base build/base --steps

It prints the card, one line a measurement and a JSON summary last.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

CSRC = Path("src") / "repro_torch" / "kernels" / "csrc"
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
#: (shape, A): mamba2-130m's training shape, then the sweep's
SHAPES = {"mamba_train": (cs.SSD_MAIN, None),
          **{"sweep_" + "x".join(map(str, shape)): (shape, A)
             for shape, A in cs.SSD_BWD_SWEEP}}
STEPS = 3
#: the C signature without ``tma``
_ARGTYPES_NO_TMA = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 9
                    + [ctypes.c_int, ctypes.c_void_p])


def build_tree(tree: Path, name: str) -> _build.Built:
    """``tree``'s ``ssd_bwd.cu``, with its own headers, into
    ``build/ssd_bwd_<name>.so``."""
    src = tree / CSRC / "ssd_bwd.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"ssd_bwd_{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    return _build.Built(ctypes.CDLL(str(out)), out,
                        time.perf_counter() - t0, log)


def variant_tree(name: str, edits: list) -> Path:
    """This tree's ``ssd_bwd.cu`` and ``hopper.cuh`` with ``edits`` applied,
    under ``build/var_<name>``."""
    out = _build.BUILD_DIR / f"var_{name}"
    shutil.rmtree(out, ignore_errors=True)
    (out / CSRC).mkdir(parents=True)
    for f in ("ssd_bwd.cu", "hopper.cuh"):
        s = (ROOT / CSRC / f).read_text()
        for file, old, new, count in edits:
            if file == f:
                if s.count(old) != count:
                    raise ValueError(f"variant {name}: {old[:60]!r} occurs "
                                     f"{s.count(old)} times in {f}, not "
                                     f"{count}")
                s = s.replace(old, new)
        (out / CSRC / f).write_text(s)
    return out


def caller(built: _build.Built, source: str):
    """``f(x, dt, A, B, C, D, gy, gstate)`` -> the six gradients from this
    build's entry point, its scratch allocated as its source expects."""
    lib = built.lib
    with_tma = re.search(r"int\s+dtype,\s*int\s+tma,", source) is not None
    lib.ssd_bwd.restype = ctypes.c_int
    lib.ssd_bwd.argtypes = ssd._BWD_ARGTYPES if with_tma else _ARGTYPES_NO_TMA

    def call(x, dt, A, B, C, D, gy, gstate=None):
        b, s, h, p = x.shape
        n = B.shape[-1]
        gy = gy.contiguous()
        if with_tma:
            n_cum, n_work = ssd.bwd_scratch(b, s, h, p, n, x.dtype)
        else:
            nc = -(-s // ssd.CHUNK)
            n_cum = b * h * nc * ssd.CHUNK
            n_work = 2 * b * h * nc * p * n + 2 * b * nc * h
        cum = torch.empty(max(n_cum, 1), dtype=torch.float64,
                          device=x.device)
        work = torch.empty(n_work, dtype=torch.float32, device=x.device)
        outs = ssd._bwd_outputs(x, B)
        route = ([int(x.dtype == torch.bfloat16
                      and ssd.tma_route(x, B, C, gy))] if with_tma else [])
        err = lib.ssd_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), gy.data_ptr(),
            None if gstate is None else gstate.data_ptr(),
            *(t.data_ptr() for t in outs), cum.data_ptr(), work.data_ptr(),
            b, s, h, p, n, x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), ssd._DTYPES[x.dtype], *route,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{built.path.name}: launch failed ({err})")
        return outs

    return call


def short(kernel: str) -> str:
    """A traced kernel's name without its namespaces and arguments."""
    name = re.sub(r"\(anonymous namespace\)::|tc::|void ", "", kernel)
    return name.split("(")[0]


def gaps(got, want) -> dict:
    """This build's outputs against the base's: bf16 leaves row by row, the
    others against the leaf's largest element."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        if g.dtype == torch.bfloat16:
            out[name] = cs.row_rel_err(g, w)
        else:
            out[name] = ((g - w).abs().max()
                         / w.abs().max().clamp_min(1e-30)).item()
    return out


def kernel_turns(calls: dict, rng) -> dict:
    order = list(calls) + list(calls)[::-1]
    out = {}
    for label, (shape, A) in SHAPES.items():
        b, s, h, p, n = shape
        x, dt, A_, B, C, D = cs._ssd_inputs(rng, *shape, torch.bfloat16,
                                            packed=True, A=A)
        gy = cs._randn(rng, (b, s, h, p), torch.bfloat16)
        args = (x, dt, A_, B, C, D, gy)
        outs = {tag: calls[tag](*args) for tag in calls}
        gap = {tag: gaps(outs[tag], outs["base"]) for tag in calls
               if tag != "base"}
        del outs
        times = {tag: [] for tag in calls}
        for tag in order:
            times[tag].append(cs.time_ms(lambda: calls[tag](*args), 10))
        traced = {tag: [] for tag in calls}
        for tag in order:
            traced[tag].append(cs._kernel_split(lambda: calls[tag](*args), 5,
                                                key="ssd_bwd"))
        kernels = {tag: {k: float(np.mean([t[k] for t in ts]))
                         for k in ts[0]} for tag, ts in traced.items()}
        device = {tag: sum(ks.values()) for tag, ks in kernels.items()}
        ms = {tag: float(np.mean(t)) for tag, t in times.items()}
        out[label] = {"shape": list(shape), "A": A, "turns_ms": times,
                      "ms": ms, "device_ms": device, "kernels": kernels,
                      "gap": gap}
        print(f"{label} {shape} bf16 by "
              f"{'TMA' if ssd.tma_route(x, B, C, gy) else 'threads'}: "
              + "; ".join(f"{tag} events " + " / ".join(
                  f"{t:.4f}" for t in ts) + f" ms, traced {device[tag]:.4f}"
                  for tag, ts in times.items())
              + f" ({device['base'] / device['this']:.2f}x base traced); "
              + "; ".join(f"{tag} " + ", ".join(
                  f"{short(k)} {t:.4f}" for k, t in ks.items())
                  for tag, ks in kernels.items())
              + "; against base: " + "; ".join(
                  f"{tag} " + ", ".join(f"{k} {v:.2e}" for k, v in g.items())
                  for tag, g in gap.items()), flush=True)
        del x, dt, A_, B, C, D, gy, args
        cs.free()
    return out


def step_turns(calls: dict) -> dict:
    """mamba2-130m's warm training steps with the model's SSD backward
    routed to each build in turns, and one traced step a build."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim import adamw
    _, model, step, batches = cs.lm_train_setup(cs.MAMBA, cs.MAMBA_B,
                                                cs.MAMBA_S)
    params = model.param_tree()
    opt = adamw.init(params)
    batch = next(batches)
    own = ssd.ssd_bwd
    route = {"base": calls["base"], "this": own}
    times = {"base": [], "this": []}
    i = 0
    try:
        for tag in ("base", "this", "this", "base"):
            ssd.ssd_bwd = route[tag]
            params, opt, met = step(params, opt, batch, i)   # unmeasured
            float(met["loss"])
            i += 1
            for _ in range(STEPS):
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch, i)
                float(met["loss"])
                times[tag].append((time.perf_counter() - t0) * 1e3)
                i += 1
        traced = {}
        for tag in ("base", "this"):
            ssd.ssd_bwd = route[tag]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch, i)
                float(met["loss"])
                wall = (time.perf_counter() - t0) * 1e3
            i += 1
            busy, per = cs._device_ms(prof)
            traced[tag] = {"wall_ms": wall, "busy_ms": busy,
                           "ssd_bwd_ms": sum(v for k, v in per.items()
                                             if "ssd_bwd" in k)}
    finally:
        ssd.ssd_bwd = own
    ms = {tag: float(np.mean(t)) for tag, t in times.items()}
    print(f"{cs.MAMBA} train step ({cs.MAMBA_B} x {cs.MAMBA_S}): warm ms "
          + "; ".join(f"{tag} " + " / ".join(f"{t:.1f}" for t in ts)
                      for tag, ts in times.items())
          + f" (means {ms['base']:.1f}, {ms['this']:.1f}); traced "
          + "; ".join(f"{tag} wall {x['wall_ms']:.1f} busy "
                      f"{x['busy_ms']:.1f} ssd_bwd {x['ssd_bwd_ms']:.2f}"
                      for tag, x in traced.items()), flush=True)
    return {"turns_ms": times, "ms": ms, "traced": traced}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True,
                    help="a tree whose csrc/ssd_bwd.cu is the base")
    ap.add_argument("--variants", type=Path,
                    help="JSON of named text edits of this tree's source")
    ap.add_argument("--steps", action="store_true",
                    help="also time mamba2-130m's training steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card()}")
    trees = {"base": args.base.resolve()}
    if args.variants:
        for name, edits in json.loads(args.variants.read_text()).items():
            trees[name] = variant_tree(name, edits)
    with ThreadPoolExecutor(len(trees) + 1) as pool:
        this = pool.submit(_build.build, "ssd_bwd")
        other = dict(zip(trees, pool.map(build_tree, trees.values(),
                                         trees)))
        built = {"base": other.pop("base"), "this": this.result(), **other}
    sources = {tag: (trees.get(tag, ROOT) / CSRC / "ssd_bwd.cu").read_text()
               for tag in built}
    for tag, b in built.items():
        spills = [line.strip() for line in b.log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")]
        print(f"build {tag}: {b.seconds:.1f} s -> {b.path.name}; spills "
              f"{spills}")
    calls = {tag: caller(built[tag], sources[tag]) for tag in built}
    summary = {"card": cs.card(),
               "kernels": kernel_turns(calls, np.random.default_rng(0))}
    if args.steps:
        summary["steps"] = step_turns(calls)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
