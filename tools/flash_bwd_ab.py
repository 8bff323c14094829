"""The flash backward's kernels against another tree's, on one card.

Builds ``src/repro_torch/kernels/csrc/flash_bwd.cu`` of this tree (through
``kernels._build``) and of another tree (``--base DIR``: a checkout of an
earlier commit, unpacked from ``git archive``) with the same ``nvcc``
flags, and routes ``kernels.flash_attention.flash_bwd`` to one build or the
other in turns inside one process:

* the backward alone at ``chip_smoke.py``'s ten training shapes (bf16):
  base, this, SDPA's backward (``chip_smoke.sdpa_backward``), then the same
  in reverse, CUDA events over 20 calls a turn, then the same turns
  traced (``torch.profiler``, 5 calls a turn): each build's delta, dK/dV
  and dQ kernels apart, and the device time of every kernel SDPA's
  backward launches, which a busy host does not stretch as it stretches
  the events' reading of a call with little device work; and how far
  this tree's dq/dk/dv lie from the base's, row by row
  (``chip_smoke.row_rel_err``, dq floored as ``_bwd_at`` floors it);
* with ``--variants FILE``, more builds in the same turns: each a copy of
  this tree's ``flash_bwd.cu`` and ``hopper.cuh`` with the text
  replacements FILE lists, a JSON object ``{"name": [[file, old, new,
  count], ...]}`` (``old`` must occur ``count`` times in ``file``);
* with ``--steps``, warm training steps (3 a turn, after one unmeasured)
  of qwen1.5-0.5b (4 x 2048), whisper-small (32 x 448 over 1500 frames,
  microbatches of 16) and the MLLM colocated step (the ViT's 12 layers
  feeding pixtral-12b's width at 2 layers, 8 x 2048 in microbatches of 2),
  set up by ``chip_smoke.py``'s own ``lm_train_setup``,
  ``whisper_train_setup`` and ``mllm_setup``, one traced step a build.

Run from the repository root on a machine with the card::

    mkdir -p build/base && git archive HEAD | tar -x -C build/base
    python3 tools/flash_bwd_ab.py --base build/base --steps

It prints the card, one line a measurement and a JSON summary last.
"""
import argparse
import ctypes
import json
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402

#: chip_smoke.py's training shapes (B, S, T, H, KV, D) and causality
SHAPES = {"train_distill": (cs.TRAIN_ATTN, True),
          "multi_teacher": (cs.MT_ATTN, True),
          "mllm_vit": (cs.MLLM_VIT_ATTN, False),
          "mllm_llm": (cs.MLLM_LM_ATTN, True),
          "moe_train": (cs.MOONSHOT_ATTN, True),
          "moe_train_mb": (cs.MOONSHOT_MB_ATTN, True),
          "whisper_enc": (cs.WHISPER_ENC_ATTN, False),
          "whisper_self": (cs.WHISPER_SELF_ATTN, True),
          "whisper_cross": (cs.WHISPER_CROSS_ATTN, False),
          "tp_repeat_rank": (cs.TP_REPEAT_ATTN, True)}
STEPS = 3
CSRC = Path("src") / "repro_torch" / "kernels" / "csrc"


def build_tree(tree: Path, name: str) -> _build.Built:
    """``tree``'s ``flash_bwd.cu``, with its own headers, into
    ``build/flash_bwd_<name>.so``."""
    src = tree / CSRC / "flash_bwd.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"flash_bwd_{name}.so"
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
    """This tree's ``flash_bwd.cu`` and ``hopper.cuh`` with ``edits``
    applied, under ``build/var_<name>``."""
    out = _build.BUILD_DIR / f"var_{name}"
    shutil.rmtree(out, ignore_errors=True)
    (out / CSRC).mkdir(parents=True)
    for f in ("flash_bwd.cu", "hopper.cuh"):
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


def use(built: _build.Built) -> None:
    """Route ``fa.flash_bwd`` on CUDA tensors to this build."""
    _build._LOADED["flash_bwd"] = built


def split_of(call) -> dict:
    return cs.flash_bwd_parts(cs._kernel_split(
        call, 5, "flash_bwd_", once=cs.FLASH_BWD_PARTS))


def kernel_turns(builds: dict, rng) -> dict:
    names = list(builds)
    order = names + ["sdpa"] + ["sdpa"] + names[::-1]
    out = {}
    for name, (shape, causal) in SHAPES.items():
        B, S, T, H, KV, D = shape
        q = cs._randn(rng, (B, S, H, D), torch.bfloat16)
        k, v = (cs._randn(rng, (B, T, KV, D), torch.bfloat16)
                for _ in range(2))
        do = cs._randn(rng, (B, S, H, D), torch.bfloat16)
        o, lse = fa.flash_fwd(q, k, v, causal=causal)

        def call():
            return fa.flash_bwd(q, k, v, o, lse, do, causal=causal)

        sdpa = cs.sdpa_backward(q, k, v, do, causal)
        times = {tag: [] for tag in names + ["sdpa"]}
        grads = {}
        for tag in order:
            if tag == "sdpa":
                times[tag].append(cs.time_ms(sdpa, iters=20))
                continue
            use(builds[tag])
            grads.setdefault(tag, call())
            times[tag].append(cs.time_ms(call, iters=20))
        traces = {tag: [] for tag in names + ["sdpa"]}
        for tag in order:
            if tag == "sdpa":
                traces[tag].append({"device": sum(cs._kernel_split(
                    sdpa, 5, key="").values())})
                continue
            use(builds[tag])
            traces[tag].append(split_of(call))
        del sdpa
        split = {tag: {p: float(np.mean([x[p] for x in xs])) for p in xs[0]}
                 for tag, xs in traces.items()}
        torch.cuda.synchronize()
        gap = {}
        for tag in names[1:]:
            gap[tag] = {}
            for i, g in enumerate(("dq", "dk", "dv")):
                want = grads["base"][i]
                floor = (cs.BWD_ROW_FLOOR * want.float().abs().max().item()
                         if g == "dq" else 0.0)
                gap[tag][g] = cs.row_rel_err(grads[tag][i], want, floor)
        del grads
        ms = {tag: float(np.mean(t)) for tag, t in times.items()}
        out[name] = {"shape": list(shape), "causal": causal,
                     "turns_ms": times, "ms": ms, "kernels": split,
                     "traced_turns": traces, "row_gap": gap}
        print(f"{name} {shape} {'causal' if causal else 'non-causal'}: "
              + "; ".join(f"{tag} " + " / ".join(f"{t:.4f}" for t in ts)
                          + " ms" for tag, ts in times.items())
              + f" ({ms['base'] / ms['this']:.2f}x base); kernels "
              + "; ".join(f"{tag} " + ", ".join(f"{p} {t:.4f}"
                                                for p, t in s.items())
                          for tag, s in split.items())
              + "; against base, row by row: "
              + "; ".join(f"{tag} " + ", ".join(f"{g} {e:.3e}"
                                                for g, e in x.items())
                          for tag, x in gap.items()), flush=True)
        del q, k, v, do, o, lse
        cs.free()
    return out


def step_turns(builds: dict, what: str, step, state, batch) -> dict:
    """Warm steps of ``step`` with each build in turns (base, this, this,
    base), and one traced step a build: wall ms, device busy ms and the
    flash backward's kernels."""
    from torch.profiler import ProfilerActivity, profile
    params, opt = state
    times = {"base": [], "this": []}
    i = 0
    for tag in ("base", "this", "this", "base"):
        use(builds[tag])
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
        use(builds[tag])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch, i)
            float(met["loss"])
            wall = (time.perf_counter() - t0) * 1e3
        i += 1
        busy, per = cs._device_ms(prof)
        traced[tag] = {"wall_ms": wall, "busy_ms": busy,
                       **{f"flash_bwd_{p}_ms": t
                          for p, t in cs.flash_bwd_parts(per).items()}}
    ms = {tag: float(np.mean(t)) for tag, t in times.items()}
    print(f"{what}: warm ms base " + " / ".join(f"{t:.1f}"
                                                for t in times["base"])
          + ", this " + " / ".join(f"{t:.1f}" for t in times["this"])
          + f" (means {ms['base']:.1f}, {ms['this']:.1f}); traced "
          + "; ".join(f"{tag} wall {x['wall_ms']:.1f} busy "
                      f"{x['busy_ms']:.1f}, flash_bwd dkdv "
                      f"{x['flash_bwd_dkdv_ms']:.2f} dq "
                      f"{x['flash_bwd_dq_ms']:.2f} delta "
                      f"{x['flash_bwd_delta_ms']:.2f}"
                      for tag, x in traced.items()), flush=True)
    return {"turns_ms": times, "ms": ms, "traced": traced}


def lm_step():
    from repro_torch.optim import adamw
    _, model, step, batches = cs.lm_train_setup()
    params = model.param_tree()
    return step, (params, adamw.init(params)), next(batches)


def whisper_step():
    from repro_torch.optim import adamw
    _, model, step, batches = cs.whisper_train_setup()
    params = model.param_tree()
    return step, (params, adamw.init(params)), next(batches)


def mllm_step():
    """The colocated step of ``chip_smoke.phase_mllm``'s (a) on its first
    batch, planned by the runtime's planner."""
    from repro_torch.mllm import workload as mw
    from repro_torch.optim import adamw
    dev = torch.device("cuda", 0)
    vit_cfg, lm_cfg, kw = cs.mllm_setup(dev)
    (batch,) = cs.mllm_batches(vit_cfg, lm_cfg, cs.MLLM_RATIO, 0, 1)
    with mw.MLLMRuntime(vit_cfg, lm_cfg, **kw) as planner:
        plan = planner.plan_iteration(batch["has_image"])
    step = mw.build_colocated_step(vit_cfg, lm_cfg, device=dev,
                                   lr_schedule=kw["lr_schedule"])
    params = mw.init_compound_params(vit_cfg, lm_cfg, seed=0, device=dev)
    return step, (params, adamw.init(params)), mw.colocated_batch(batch,
                                                                  plan)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, required=True,
                    help="a tree whose csrc/flash_bwd.cu is the base")
    ap.add_argument("--variants", type=Path,
                    help="JSON of named text edits of this tree's source")
    ap.add_argument("--steps", action="store_true",
                    help="also time the qwen, whisper and MLLM steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card()}")
    trees = {"base": args.base.resolve()}
    if args.variants:
        for name, edits in json.loads(args.variants.read_text()).items():
            trees[name] = variant_tree(name, edits)
    with ThreadPoolExecutor(len(trees) + 1) as pool:
        this = pool.submit(_build.build, "flash_bwd")
        other = dict(zip(trees, pool.map(build_tree, trees.values(),
                                         trees)))
        builds = {"base": other.pop("base"), "this": this.result(),
                  **other}
    for tag, built in builds.items():
        spills = [line.strip() for line in built.log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")]
        print(f"build {tag}: {built.seconds:.1f} s -> {built.path.name}; "
              f"spills {spills}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {"card": cs.card(),
               "kernels": kernel_turns(builds, np.random.default_rng(0))}
    if args.steps:
        for what, make in (("qwen1.5-0.5b train step", lm_step),
                           ("whisper-small train step", whisper_step),
                           ("mllm colocated step", mllm_step)):
            step, state, batch = make()
            summary[what] = step_turns(builds, what, step, state, batch)
            del step, state, batch
            cs.free()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
