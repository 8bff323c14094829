#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); it builds the port's
CUDA kernels from the sources in this checkout.  Phases:

1. Card and build: the card's name and power limit from ``nvidia-smi``;
   ``kernels/csrc/flash_fwd.cu``, ``distill_kl_fwd.cu`` and ``ssd_fwd.cu``
   built by one ``nvcc`` each, started together; the counts of ``HGMMA``
   (wgmma) and ``UTMALDG`` (TMA load) instructions in the SASS of the
   flash, KL and SSD libraries, each of which must have both: their bf16
   paths run on the tensor cores from TMA-fed shared memory, their float32
   paths on the CUDA cores.
2. The flash kernel against its plain version (``kernels/ref.py``) on the
   card, over a sweep of shapes, masks and dtypes (bf16 through the
   tensor-core path, float32 through the CUDA-core path), and at the two
   main-path shapes, granite-3-8b's serving prefill and qwen1.5-0.5b's
   training and distillation attention, where the kernel, the plain
   version and PyTorch's ``scaled_dot_product_attention`` are timed.  Then
   its gradients: autograd through ``ops.flash_attention[_lse]`` (kernel
   forward, blockwise backward) against autograd through the plain
   version, over a sweep and at the training shape.
3. The distillation-KL kernel against its plain version over a sweep
   (ragged N and V, Ds != Dt, T in {1, 2}, f32 and bf16, with and without
   a mask, W contiguous and W as ``embed.T``), then at the main-path shape
   (N = 8192, D = 1024, V = 151936, bf16), where the kernel, the plain
   version and the materialised form in PyTorch calls are timed.
4. Serving: ``launch.serve.serve`` runs granite-3-8b at full width in bf16
   (random weights from a seed), batch 4, prompt 2048, 32 generated
   tokens; the flash kernel must be launched once per layer in prefill.
   A warm run is timed and traced with ``torch.profiler``; prefill of S-2
   tokens then 2 decode steps must give ``forward``'s logits (4 layers,
   float32).
5. Training: ``launch.train.run`` trains qwen1.5-0.5b at full width in
   bf16, batch 4 x seq 2048; losses and grad norms finite, weights
   changed, the flash kernel launched twice per layer and step (forward
   and the recompute of the checkpointed layer).  One warm step of the
   same model is traced.
6. Distillation: ``distill.workload.build_colocated_step``, teacher
   qwen1.5-0.5b (seed 1, frozen) and student qwen1.5-0.5b (seed 0) at full
   width in bf16, batch 4 x seq 2048, alpha 0.5, T 2, 3 steps; the KL
   kernel launched once per step; one warm step traced.  Then one
   distillation step's gradients at full width (2 layers, float32) on the
   kernels against the same step on CPU copies, which take the plain
   versions.
7. The SSD scan kernel against its plain version (``ssd_scan_ref``) over
   a sweep (lengths below, at and above its 64-token chunk, ragged, f32
   and bf16, with and without the final state, x/B/C as strided slices of
   one tensor; each case prints its route: CUDA cores for f32, tensor
   cores with TMA or threads' loads for bf16) and 1024 chunks (bf16, the
   final state), then at mamba2-130m's shape (b=4, s=4096, h=24, p=64,
   n=128, bf16, by TMA), where the kernel and the plain version are timed
   and its kernels' device times traced.  Its
   gradients: autograd through ``ops.ssd_scan`` (kernel forward,
   ``ssd_chunked`` backward) against autograd through the sequential
   ``ssd_reference``, over a sweep and in ROADMAP C3's case (chunk 128,
   A = -1), where every gradient must be finite.
8. mamba2-130m at full width in bf16: ``launch.train.run``, batch 4 x seq
   4096, 4 steps (SSD kernel launched twice per layer and step, flash
   never), one warm step traced; ``launch.serve.serve``, batch 4, prompt
   4096, 32 tokens (SSD launched once per layer in prefill, never in
   decode), then timed warm.  Prefill of S-2 tokens and 2 decode steps
   against ``forward`` (4 layers, float32), and one train step's
   gradients (2 layers, float32) against the same step on the CPU.
9. A ``{"kernels": [...]}`` line with each kernel's launches on the main
   paths, error and times (the flash kernel's at each of its main-path
   shapes under ``at``; its top-level times are the serving prefill's),
   then the ``{"ok": true, ...}`` line.

Any failed check raises, so the script exits non-zero and prints no
result.  It exits non-zero without a CUDA card, and when run from a
directory that holds no ``src/repro_torch``.
"""
from __future__ import annotations

import functools
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM data sheet (dense): bf16 tensor-core peak and HBM bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# the libraries whose bf16 path runs wgmma on TMA-fed shared memory, and the
# SASS instructions that show it
TENSOR_CORE_LIBS = ("flash_fwd", "distill_kl_fwd", "ssd_fwd")
SASS_OPS = ("HGMMA", "UTMALDG")
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
# tests/test_kernels_flash.py's sweep (B, S, T, H, KV, D), plus a ragged length
SWEEP = [(2, 128, 128, 4, 2, 16), (1, 256, 256, 8, 8, 32),
         (2, 128, 64, 4, 1, 16), (1, 64, 64, 6, 3, 8),
         (2, 200, 200, 4, 2, 64)]
MODES = [(True, 0), (False, 0), (True, 32)]
PREFILL = (4, 2048, 2048, 32, 8, 128)    # granite-3-8b serving prefill
TRAIN_ATTN = (4, 2048, 2048, 16, 16, 64)  # qwen1.5-0.5b train and distill
ARCH = "granite-3-8b"
# flash gradients: f32 (TF32 off) within 1e-4; bf16 within 2e-2, about one
# bf16 step at the gradients' magnitude (up to ~4): both sides compute in
# f32, the kernel's o is rounded to bf16 before the backward reads it
GRAD_SWEEP = [(2, 128, 128, 4, 2, 16), (1, 256, 256, 8, 8, 32),
              (2, 200, 200, 4, 2, 64)]
GRAD_MODES = [(True, 0), (False, 0), (True, 32)]
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# distill_kl statistics and KL: both sides sum f32 products of the same
# inputs in other orders, over D <= 1024 and V <= 151936, on values up to
# ~15 (lse); 2e-4 is far below what a wrong max, scale or tile moves
KL_TOL = 2e-4
# N, Ds, Dt, V, dtype, T, W layout, masked
KL_SWEEP = [(200, 64, 96, 1000, torch.float32, 1.0, "rows", False),
            (333, 128, 64, 5003, torch.bfloat16, 2.0, "embed_t", True),
            (64, 256, 256, 64, torch.float32, 2.0, "embed_t", True),
            (1000, 1024, 1024, 4099, torch.bfloat16, 1.0, "embed_t", False),
            (129, 96, 160, 2000, torch.float32, 1.0, "rows", True),
            (77, 1024, 512, 30000, torch.bfloat16, 2.0, "rows", False)]
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_B, TRAIN_S = 4, 2048
TRAIN_STEPS = 4
DISTILL_STEPS = 3
# SSD scan kernel against ssd_scan_ref, both f32 inside: f32 inputs (TF32
# off) within 1e-4 of 1 + |ref| (sums in other orders over n <= 128 and
# 64-token chunks); bf16 within 1e-2, past the one bf16 step (at most
# 2**-7 relative) by which two roundings of nearly equal f32 sums differ.
# The final state is f32 on both sides: 1e-4 in both dtypes.
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_STATE_TOL = 1e-4
# (b, s, h, p, n): tests/test_kernels_ssd.py's sweep, a ragged length, one
# chunk's, mamba2-130m's p and n at the consistency check's ragged 4094
SSD_SWEEP = [(2, 64, 3, 8, 16), (1, 128, 2, 16, 8), (2, 48, 4, 8, 4),
             (1, 200, 2, 16, 8), (2, 4094, 4, 64, 128), (1, 130, 3, 80, 72)]
SSD_MAIN = (4, 4096, 24, 64, 128)       # mamba2-130m training and prefill
# 1024 chunks: 2048 blocks of the bf16 output kernel, far more than the
# card holds at once, each reading a state the state kernel carried
# through up to 1023 chunks
SSD_LONG = (2, 65536, 8, 64, 128)
# SSD gradients through ops.ssd_scan against autograd through the
# sequential oracle, relative to the leaf's largest gradient: f32 within
# 1e-3 (the backward sums over up to 256 tokens in other orders); bf16
# within 2e-2, a few bf16 steps (x, B, C and their gradients are bf16)
SSD_GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
SSD_GRAD_SWEEP = [((2, 64, 3, 8, 16), 16), ((2, 64, 3, 8, 16), 128),
                  ((1, 128, 2, 16, 8), 32), ((2, 48, 4, 8, 4), 16),
                  ((1, 200, 2, 16, 8), 64)]
MAMBA = "mamba2-130m"
MAMBA_B, MAMBA_S = 4, 4096


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def _randn(rng, shape, dtype, device="cuda"):
    x = rng.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def sass_counts(lib: Path) -> dict:
    """Counts of HGMMA and UTMALDG instructions in a library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-sass", str(lib)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {lib}: {out.stderr}")
    return {op: sum(1 for line in out.stdout.splitlines() if op in line)
            for op in SASS_OPS}


def phase_build() -> None:
    from repro_torch.kernels import _build
    print(f"card: {card()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    builds = _build.build_all(["flash_fwd", "distill_kl_fwd", "ssd_fwd"])
    print(f"build: {time.perf_counter() - t0:.1f} s wall for "
          f"{len(builds)} sources in parallel")
    for name, built in builds.items():
        print(f"build {name}: {built.seconds:.1f} s -> {built.path.name}")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
            elif ("Compiling entry function" in line
                  or "Performance Loss" in line):
                print("  ptxas:", line.strip()[:200])
    # the bf16 paths must run on the tensor cores (HGMMA) from TMA loads
    # (UTMALDG): count both in the SASS of each library that has them
    for name in TENSOR_CORE_LIBS:
        counts = sass_counts(builds[name].path)
        print(f"sass {name}: " + ", ".join(f"{k} {v}"
                                          for k, v in counts.items()))
        check(all(counts.values()),
              f"{name}'s SASS lacks one of {SASS_OPS}: {counts}")
    # the float32 plain versions must not round through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for float32 matmuls and cuDNN")


def compare(o, lse, o_ref, lse_ref, vis, dtype) -> float:
    """Max |o - o_ref| over rows with a visible key; lse checked beside it."""
    vis = vis.to(o.device)
    check(bool(torch.isfinite(o).all()), "kernel output not finite")
    err = 0.0
    if vis.any():
        err = (o.float() - o_ref.float())[:, vis].abs().max().item()
        lerr = (lse - lse_ref)[:, vis].abs().max().item()
        check(err <= TOL[dtype], f"o error {err:.3e} > {TOL[dtype]}")
        check(lerr <= LSE_TOL, f"lse error {lerr:.3e} > {LSE_TOL}")
    if not vis.all():
        check(bool((lse[:, ~vis] <= -1e29).all())
              and bool((o[:, ~vis] == 0).all()),
              "rows with no visible key must give o = 0, lse <= -1e29")
    return err


def run_case(rng, shape, dtype, causal, window, q_offset=0, positions=None,
             strided=False):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref, visible_mask
    B, S, T, H, KV, D = shape
    if strided:     # [B, H, S, D] storage seen as [B, S, H, D]
        q = _randn(rng, (B, H, S, D), dtype).transpose(1, 2)
        k = _randn(rng, (B, KV, T, D), dtype).transpose(1, 2)
        v = _randn(rng, (B, KV, T, D), dtype).transpose(1, 2)
    else:
        q = _randn(rng, (B, S, H, D), dtype)
        k = _randn(rng, (B, T, KV, D), dtype)
        v = _randn(rng, (B, T, KV, D), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_positions=positions)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    vis = visible_mask(S, T, causal=causal, window=window, q_offset=q_offset,
                       kv_positions=positions, device=q.device).any(dim=1)
    err = compare(o, lse, o_ref, lse_ref, vis, dtype)
    print(f"  flash {shape} {str(dtype)[6:]} causal={causal} window={window}"
          f" q_offset={q_offset} positions={positions is not None}"
          f"{' strided' if strided else ''}: "
          f"max|o-ref| {err:.3e} (tol {TOL[dtype]:.0e}), "
          f"hidden rows {int((~vis).sum())}")
    return q, k, v, o, err


def phase_sweep(rng) -> None:
    print("flash kernel vs plain version (f32 tol 2e-5, bf16 tol 2e-2, "
          f"lse tol {LSE_TOL:.0e})")
    for shape in SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window in MODES:
                run_case(rng, shape, dtype, causal, window)
    perm = torch.from_numpy(rng.permutation(128).astype(np.int32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window in MODES:
            run_case(rng, (1, 64, 128, 4, 2, 32), dtype, causal, window,
                     q_offset=32, positions=perm)
        run_case(rng, (2, 200, 200, 4, 2, 64), dtype, True, 0, strided=True)


def phase_flash_shape(rng, shape) -> dict:
    """The kernel at one main-path shape (bf16, causal, S == T): checked
    against its plain version, then timed beside the plain version and
    PyTorch's ``scaled_dot_product_attention``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    B, S, T, H, KV, D = shape
    q, k, v, o, err = run_case(rng, shape, torch.bfloat16, True, 0)
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, causal=True), iters=10)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                       iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_err = (library().transpose(1, 2).float() - o.float()).abs().max().item()
    library_ms = time_ms(library, iters=10)
    pairs = S * (S + 1) // 2                      # causal, S == T
    flops = 4 * B * H * D * pairs
    nbytes = 2 * (2 * B * S * H * D + 2 * B * T * KV * D) + 4 * B * S * H
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"flash at {shape} bf16 causal: kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
          f"sdpa {library_ms:.3f} ms (|sdpa-kernel| {lib_err:.3e}), "
          f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)")
    return {"shape": list(shape), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def flash_entry(at: dict) -> dict:
    """The flash kernel's line: the serving prefill shape's numbers at the
    top, each main-path shape's under ``at``, the worst error of all."""
    return {"name": "flash_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:51",
            "launches": None,
            **{k: v for k, v in at["serve"].items() if k != "shape"},
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "at": at}


def reset_counts() -> None:
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    fa.flash_fwd.launches = 0
    dk.distill_kl_fwd.launches = 0
    ssd.ssd_fwd.launches = 0


def read_counts() -> tuple[int, int, int]:
    """(flash_fwd, distill_kl_fwd, ssd_fwd) launches since reset_counts."""
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    return (fa.flash_fwd.launches, dk.distill_kl_fwd.launches,
            ssd.ssd_fwd.launches)


def phase_serve() -> int:
    from repro_torch.launch import serve as serve_mod
    torch.cuda.reset_peak_memory_stats()
    B, S, _, _, _, _ = PREFILL
    reset_counts()
    t0 = time.perf_counter()
    res = serve_mod.serve(ARCH, batch=B, prompt_len=S, gen=32,
                          dtype="bfloat16", device="cuda", seed=0)
    wall = time.perf_counter() - t0
    launches, kl_launches, ssd_launches = read_counts()
    check(kl_launches == ssd_launches == 0,
          "serving granite launched the distill_kl or the SSD kernel")
    cfg = res.cfg
    print(res.summary())
    print(f"serve wall (init + prefill + decode): {wall:.1f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(res.prefill_launches == cfg.num_layers,
          f"prefill launched the kernel {res.prefill_launches} times, "
          f"expected {cfg.num_layers}")
    check(launches == cfg.num_layers, f"{launches} launches on the main path")
    check(tuple(res.tokens.shape) == (B, 32), f"tokens {res.tokens.shape}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "generated token outside the vocabulary")
    check(res.logits_finite, "non-finite logits")
    return launches


def _device_ms(prof) -> tuple[float, dict]:
    """Total device time of a trace and its largest kernels, in ms."""
    per = {}
    for evt in prof.key_averages():
        t = evt.self_device_time_total
        if evt.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            per[evt.key] = per.get(evt.key, 0.0) + t / 1e3
    return sum(per.values()), per


def phase_profile(rng) -> None:
    """Where the time of a warm prefill and decode step goes: host wall time
    beside device time by kernel (torch.profiler), same model and shapes as
    the main path."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    B, S = PREFILL[:2]
    cfg = serve_mod.resolve_config(ARCH, dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).cuda()
    serve_mod.generate(model, prompts, 2)                      # warm-up
    print("warm " + serve_mod.generate(model, prompts, 32).summary())
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": prompts}, extra_cache=9)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        tok = logits.argmax(-1)[:, None]
        for i in range(8):
            logits, cache = model.decode(cache, tok, S + i)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall_d = (time.perf_counter() - t0) * 1e3 / 8
    for name, p, wall, per_what in (("prefill", prof, wall_p, "prefill"),
                                    ("decode", prof_d, wall_d, "token")):
        busy, per = _device_ms(p)
        if name == "decode":
            busy, per = busy / 8, {k: v / 8 for k, v in per.items()}
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        check(busy > 0, f"the profiler saw no device time in {name}")
        print(f"traced {name}: wall {wall:.1f} ms/{per_what}, device busy "
              f"{busy:.1f} ms ({100 * busy / wall:.0f}%, idle "
              f"{100 * (1 - busy / wall):.0f}%), {len(per)} kernel kinds")
        for key, ms in top:
            print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {key[:90]}")


def phase_consistency(rng) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(ARCH).replace(num_layers=4, dtype="float32")
    model = build_model(cfg, device="cuda", seed=1)
    B, S = 2, 130
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).cuda()
    full = model({"tokens": tokens})
    logits, cache = model.prefill({"tokens": tokens[:, :S - 2]},
                                  extra_cache=2)
    errs = [(logits - full[:, S - 3]).abs().max().item()]
    for pos in (S - 2, S - 1):
        logits, cache = model.decode(cache, tokens[:, pos:pos + 1], pos)
        errs.append((logits - full[:, pos]).abs().max().item())
    scale = full.abs().max().item()
    # float32 with TF32 off: the kernel, cuBLAS and decode's einsums sum the
    # 4096-wide contractions in different orders; 1e-3 is far above that
    # rounding and far below what a wrong mask or cache slot moves (O(0.1))
    tol = 1e-3
    print(f"consistency {cfg.name} d_model={cfg.d_model} layers=4 f32, "
          f"S={S}: prefill/decode vs forward max|diff| "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:.0e}; "
          f"max |logit| {scale:.2f})")
    check(max(errs) <= tol, "prefill + decode disagrees with forward")


def _grad_case(rng, shape, dtype, causal, window) -> float:
    """Worst relative gradient error of one case, with and without an lse
    cotangent; fails the run past GRAD_TOL."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    B, S, T, H, KV, D = shape
    leaves = [_randn(rng, s, dtype).requires_grad_()
              for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]
    do = _randn(rng, (B, S, H, D), torch.float32)
    dlse = _randn(rng, (B, S, H), torch.float32)
    kw = dict(causal=causal, window=window)
    worst = 0.0
    for with_lse in (False, True):
        if with_lse:
            o, lse = ops.flash_attention_lse(*leaves, **kw)
            loss = (o.float() * do).sum() + (lse * dlse).sum()
        else:
            o = ops.flash_attention(*leaves, **kw)
            loss = (o.float() * do).sum()
        check("FlashAttention" in type(o.grad_fn).__name__,
              f"CUDA attention output has grad_fn {o.grad_fn}")
        got = torch.autograd.grad(loss, leaves)
        o_r, lse_r = flash_attention_ref(*leaves, **kw)
        loss_r = (o_r.float() * do).sum()
        if with_lse:
            loss_r = loss_r + (lse_r * dlse).sum()
        want = torch.autograd.grad(loss_r, leaves)
        torch.cuda.synchronize()
        for name, g, w in zip("qkv", got, want):
            err = ((g.float() - w.float()).abs()
                   / (1 + w.float().abs())).max().item()
            worst = max(worst, err)
            check(err <= GRAD_TOL[dtype],
                  f"d{name} {shape} {dtype} causal={causal} window={window} "
                  f"lse={with_lse}: {err:.3e} > {GRAD_TOL[dtype]}")
    return worst


def phase_flash_grads(rng) -> None:
    """Gradients through the kernel's autograd Functions against autograd
    through the plain version, with and without an lse cotangent, over a
    sweep and at the training shape."""
    print("flash gradients: ops.flash_attention[_lse] (kernel forward, "
          "blockwise backward) vs autograd through the plain version "
          f"(f32 tol {GRAD_TOL[torch.float32]:.0e}, bf16 tol "
          f"{GRAD_TOL[torch.bfloat16]:.0e})")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in GRAD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window in GRAD_MODES:
                worst[dtype] = max(worst[dtype], _grad_case(
                    rng, shape, dtype, causal, window))
    print(f"  worst |grad - ref| / (1 + |ref|): f32 "
          f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e} "
          f"over {len(GRAD_SWEEP) * 2 * len(GRAD_MODES) * 2} cases")
    err = _grad_case(rng, TRAIN_ATTN, torch.bfloat16, True, 0)
    print(f"  at the training shape {TRAIN_ATTN} bf16 causal: "
          f"worst |grad - ref| / (1 + |ref|) {err:.3e} over 2 cases")


def _kl_inputs(rng, N, Ds, Dt, V, dtype, layout):
    h_s = _randn(rng, (N, Ds), dtype)
    h_t = _randn(rng, (N, Dt), dtype)
    ws, wt = ((_randn(rng, (V, D), torch.float32) * D ** -0.5).to(dtype).T
              if layout == "embed_t" else
              (_randn(rng, (D, V), torch.float32) * D ** -0.5).to(dtype)
              for D in (Ds, Dt))
    return h_s, ws, h_t, wt


def phase_kl_sweep(rng) -> None:
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import distill_kl_stats_ref
    print(f"distill_kl kernel vs plain version (stats and KL, tol {KL_TOL})")
    for N, Ds, Dt, V, dtype, T, layout, masked in KL_SWEEP:
        h_s, w_s, h_t, w_t = _kl_inputs(rng, N, Ds, Dt, V, dtype, layout)
        mask = (torch.from_numpy(rng.random(N) < 0.7).cuda()
                if masked else None)
        got = dk.distill_kl_fwd(h_s, w_s, h_t, w_t, T)
        want = distill_kl_stats_ref(h_s, w_s, h_t, w_t, T)
        kl = ops.distill_kl(h_s, w_s, h_t, w_t, mask=mask, temperature=T)
        kl_ref = dk._kl_from_stats(*want, mask)
        torch.cuda.synchronize()
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        kl_err = abs(kl.item() - kl_ref.item())
        print(f"  distill_kl N={N} Ds={Ds} Dt={Dt} V={V} {str(dtype)[6:]} "
              f"T={T} {layout} mask={masked}: stats max err "
              f"{max(errs):.3e}, KL {kl.item():.5f} err {kl_err:.3e}")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              "distill_kl stats not finite")
        check(max(errs) <= KL_TOL and kl_err <= KL_TOL,
              f"distill_kl disagrees with its plain version: {errs}, "
              f"{kl_err}")


def phase_kl_main(rng) -> dict:
    """The kernel at the distillation step's shape: qwen1.5-0.5b's
    vocabulary and width, batch 4 x seq 2048, tied W as embed.T, T = 2."""
    from repro_torch.kernels import distill_kl as dk
    from repro_torch.kernels.ref import distill_kl_stats_ref
    N, D, V, T = TRAIN_B * TRAIN_S, 1024, 151936, 2.0
    h_s, w_s, h_t, w_t = _kl_inputs(rng, N, D, D, V, torch.bfloat16,
                                    "embed_t")
    got = dk.distill_kl_fwd(h_s, w_s, h_t, w_t, T)
    want = distill_kl_stats_ref(h_s, w_s, h_t, w_t, T)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    check(err <= KL_TOL, f"distill_kl at the main shape: err {err:.3e}")
    kl = dk._kl_from_stats(*got).item()
    ms = time_ms(lambda: dk.distill_kl_fwd(h_s, w_s, h_t, w_t, T), iters=3,
                 warmup=1)
    plain_ms = time_ms(lambda: distill_kl_stats_ref(h_s, w_s, h_t, w_t, T),
                       iters=3, warmup=1)

    def library():
        # the materialised form: both [N, V] logits in bf16, then f32
        ls = torch.log_softmax((h_s @ w_s).float() / T, dim=-1)
        lt = torch.log_softmax((h_t @ w_t).float() / T, dim=-1)
        return (lt.exp() * (lt - ls)).sum(-1).mean()

    lib_err = abs(library().item() - kl)
    library_ms = time_ms(library, iters=3, warmup=1)
    flops = 2 * N * V * (D + D)
    nbytes = 2 * (2 * N * D + 2 * D * V) + 4 * 4 * N
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"distill_kl main shape N={N} D={D} V={V} bf16 embed.T T={T}: "
          f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.3f} ms, materialised {library_ms:.3f} ms "
          f"(|KL diff| {lib_err:.3e}), bound {bound_ms:.4f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
          f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB); stats max err "
          f"{err:.3e}, KL {kl:.5f}")
    return {"name": "distill_kl_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/distill_kl_fwd.cu",
            "replaces": "src/repro/kernels/distill_kl_pallas.py:34",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def _finite(xs) -> bool:
    return all(np.isfinite(x) for x in xs)


def _changed_leaves(new, old) -> dict:
    changed = {}

    def visit(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                visit(a[k], b[k], f"{path}/{k}")
        else:
            changed[path] = bool((a.detach() != b).any())
    visit(new, old)
    return changed


def phase_train() -> int:
    """The training entry point at full width; returns flash launches."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_mod.run(TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_B,
                        seq=TRAIN_S, dtype="bfloat16", device="cuda",
                        seed=0, log_every=1)
    launches, kl_launches, ssd_launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(run.summary())
    print(f"train peak device memory {peak:.2f} GiB; loop {run.seconds:.2f} s")
    res, cfg = run.result, run.cfg
    check(_finite(res.losses) and _finite(res.grad_norms),
          f"non-finite loss or grad norm: {res.losses}, {res.grad_norms}")
    # remat: each layer's forward runs once, and again in the backward
    want = TRAIN_STEPS * cfg.num_layers * 2
    check(launches == run.flash_launches == want,
          f"flash launched {launches} times in training, expected "
          f"steps x layers x 2 = {want}")
    check(kl_launches == ssd_launches == 0,
          "training qwen launched the distill_kl or the SSD kernel")
    names = ("embed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    changed = _changed_leaves(res.params,
                              build_model(cfg, device="cuda", seed=0)
                              .param_tree())
    print(f"train: {sum(changed.values())} of {len(changed)} parameter "
          f"leaves changed")
    for path, moved in changed.items():
        if path.rsplit("/", 1)[-1] in names:
            check(moved, f"parameter {path} did not change in training")
    return launches


def phase_train_trace(arch: str = TRAIN_ARCH, B: int = TRAIN_B,
                      S: int = TRAIN_S) -> None:
    """One warm train step of a main path's model and shapes, traced."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    from repro_torch.train import step as step_mod
    cfg = resolve_config(arch, dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    step = step_mod.build_train_step(
        model, ParallelConfig(mbs=B), ShapeConfig("train", "train", S, B),
        lr_schedule=functools.partial(schedules.constant, peak_lr=1e-4))
    params = model.param_tree()
    opt = adamw.init(params)
    batches = lm_batches(batch=B, seq_len=S, vocab=cfg.vocab_size, seed=0,
                         device="cuda")
    params, opt, met = step(params, opt, next(batches), 0)     # warm-up
    float(met["loss"])
    batch = next(batches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch, 1)
        float(met["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, f"warm train step ({cfg.name})")


def _kernel_report(prof, wall_ms: float, what: str) -> None:
    """Device busy against wall time, time by part, and the top kernels."""
    busy, per = _device_ms(prof)
    check(busy > 0, f"the profiler saw no device time in {what}")
    ranges = {}
    for evt in prof.key_averages():
        for label, key in (("flash backward (plain torch)",
                            "evaluate_function: FlashAttentionBackward"),
                           ("KL backward (plain torch)",
                            "evaluate_function: DistillKLBackward"),
                           ("SSD backward (plain torch)",
                            "evaluate_function: SSDScanBackward"),
                           ("AdamW update", "adamw.update")):
            if evt.key.endswith(key) or evt.key == key:
                ranges[label] = ranges.get(label, 0.0) + \
                    evt.device_time_total / 1e3
    kinds = {"flash forward kernel": lambda k: "flash_fwd_kernel" in k,
             "distill_kl kernels": lambda k: "distill_kl_" in k,
             "SSD forward kernels": lambda k: "ssd_" in k,
             "GEMMs": lambda k: any(x in k.lower() for x in
                                    ("gemm", "xmma", "cutlass"))}
    print(f"traced {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.0f}%, idle "
          f"{100 * (1 - busy / wall_ms):.0f}%), {len(per)} kernel kinds")
    for label, pick in kinds.items():
        ms = sum(v for k, v in per.items() if pick(k))
        print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {label}")
    for label, ms in ranges.items():
        print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {label} "
              f"(device time under its range)")
    for key, ms in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms:8.2f} ms {100 * ms / busy:5.1f}%  {key[:90]}")
    # host side: the CUDA runtime calls, where a synchronising call (a
    # free, a copy from pageable memory) drains the queue the host built
    runtime = [e for e in prof.key_averages()
               if e.key.startswith("cuda") and e.cpu_time_total > 0]
    for e in sorted(runtime, key=lambda e: -e.cpu_time_total)[:6]:
        print(f"  host {e.cpu_time_total / 1e3:8.2f} ms in {e.count:6d} x "
              f"{e.key}")


def phase_distill() -> tuple[int, int]:
    """Colocated self-distillation at full width; returns (flash, KL)
    launches of the 3 main-path steps."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.types import ParallelConfig, ShapeConfig
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.distill import workload as dw
    from repro_torch.launch.serve import resolve_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedules
    torch.cuda.reset_peak_memory_stats()
    cfg = resolve_config(TRAIN_ARCH, dtype="bfloat16")
    teacher = tree_map(lambda p: p.detach(),
                       build_model(cfg, device="cuda", seed=1).param_tree())
    params = build_model(cfg, device="cuda", seed=0).param_tree()
    step = dw.build_colocated_step(
        cfg, cfg, ShapeConfig("distill", "train", TRAIN_S, TRAIN_B),
        ParallelConfig(mbs=TRAIN_B), alpha=0.5, temperature=2.0,
        lr_schedule=functools.partial(schedules.constant, peak_lr=1e-4))
    opt = adamw.init(params)
    batches = lm_batches(batch=TRAIN_B, seq_len=TRAIN_S,
                         vocab=cfg.vocab_size, seed=0, device="cuda")
    toks = TRAIN_B * TRAIN_S
    times, mets = [], []
    reset_counts()
    for i in range(DISTILL_STEPS):
        batch = next(batches)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, teacher, batch, i)
        met = {k: float(v) for k, v in met.items()}
        times.append(time.perf_counter() - t0)
        mets.append(met)
        print(f"distill step {i}: loss {met['loss']:.4f} ce {met['ce']:.4f} "
              f"kl {met['kl']:.5f} gnorm {met['grad_norm']:.3f} "
              f"{times[-1] * 1e3:.1f} ms")
    launches, kl_launches, ssd_launches = read_counts()
    check(ssd_launches == 0, "distillation launched the SSD kernel")
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = float(np.mean(times[1:]))
    print(f"distill {cfg.name} teacher seed 1 -> student seed 0, batch "
          f"{TRAIN_B} x seq {TRAIN_S} bf16: cold {times[0] * 1e3:.1f} ms, "
          f"warm {warm * 1e3:.1f} ms/step ({toks / warm:.0f} tok/s); peak "
          f"device memory {peak:.2f} GiB")
    check(kl_launches == DISTILL_STEPS,
          f"distill_kl launched {kl_launches} times in {DISTILL_STEPS} steps")
    # teacher forward once per layer; student forward plus its recompute
    want = DISTILL_STEPS * cfg.num_layers * 3
    check(launches == want, f"flash launched {launches} times in "
          f"distillation, expected steps x layers x (1 + 2) = {want}")
    for met in mets:
        check(_finite([met["loss"], met["ce"], met["kl"],
                       met["grad_norm"]]), f"non-finite metrics {met}")
        check(met["kl"] >= -1e-4, f"negative KL {met['kl']}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    batch = next(batches)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, teacher, batch, DISTILL_STEPS)
        float(met["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    _kernel_report(prof, wall, "warm distill step")
    return launches, kl_launches


def phase_grad_consistency(rng) -> None:
    """One distillation step's gradients at full width on the kernels
    against the same step on CPU copies (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.distill import workload as dw
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    cfg = get_config(TRAIN_ARCH).replace(num_layers=2, dtype="float32")
    # every leaf in float32: norm scales are bf16 by spec (as in the JAX
    # package), and a bf16 gradient would round by up to 2**-8 of itself
    gpu_t, gpu_s = (tree_map(lambda p: p.detach().float(),
                             build_model(cfg, device="cuda", seed=seed)
                             .param_tree()) for seed in (1, 0))
    B, S = 2, 64
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.from_numpy(
                 (rng.random((B, S)) < 0.9).astype(np.float32))}

    def grads(device):
        ps = tree_map(lambda p: p.detach().to(device).requires_grad_(),
                      gpu_s)
        pt = tree_map(lambda p: p.to(device), gpu_t)
        b = {k: v.to(device) for k, v in batch.items()}
        h_t = dw.teacher_hidden(pt, cfg, b["tokens"])
        loss, met = dw.distill_loss(ps, cfg, b, h_t,
                                    dw.teacher_unembedding(pt, cfg),
                                    alpha=0.5, temperature=2.0)
        return loss, met, torch.autograd.grad(loss, tree_leaves(ps))

    reset_counts()
    loss_g, met_g, g_gpu = grads("cuda")
    launches = read_counts()
    check(launches == (cfg.num_layers * 3, 1, 0),
          f"the CUDA step launched (flash, KL, SSD) = {launches}")
    loss_c, met_c, g_cpu = grads("cpu")
    check(read_counts() == launches, "the CPU step launched a kernel")
    rel = max(((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
              .item() for a, b in zip(g_gpu, g_cpu))
    # float32 with TF32 off on both; sums in other orders over d_model 1024
    # and V = 151936: 1e-3 relative per leaf is far above that and far
    # below a wrong term of the KL backward or of attention's
    tol = 1e-3
    print(f"gradient consistency {cfg.name} 2 layers f32 B={B} S={S}: "
          f"loss {loss_g.item():.6f} (CUDA) vs {loss_c.item():.6f} (CPU), "
          f"kl {met_g['kl'].item():.6f} vs {met_c['kl'].item():.6f}; "
          f"max per-leaf |dg| / max|g| {rel:.3e} (tol {tol:.0e}) over "
          f"{len(g_cpu)} leaves")
    check(abs(loss_g.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item()),
          "distillation loss differs between the card and the CPU")
    check(rel <= tol, "distillation gradients differ between the card and "
          "the CPU")


# --------------------------------------------------------------------------- #
# SSD scan kernel and mamba2-130m
# --------------------------------------------------------------------------- #
def _ssd_inputs(rng, b, s, h, p, n, dtype, packed=False, A=None):
    """Inputs of the SSD scan on the card: dt = softplus(N(0,1)), A =
    -exp(N(0,1)) (or the constant given), x, B, C, D ~ N(0,1).  With
    ``packed``, x, B and C are slices of one [b, s, h*p + 2n] tensor, as the
    model passes them."""
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), torch.float32))
    A = (-torch.exp(_randn(rng, (h,), torch.float32)) if A is None
         else torch.full((h,), A, device="cuda"))
    D = _randn(rng, (h,), torch.float32)
    if packed:
        xbc = _randn(rng, (b, s, h * p + 2 * n), dtype)
        x = xbc[..., :h * p].unflatten(-1, (h, p))
        B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x = _randn(rng, (b, s, h, p), dtype)
        B, C = _randn(rng, (b, s, n), dtype), _randn(rng, (b, s, n), dtype)
    return x, dt, A, B, C, D


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs()
            / (1 + want.float().abs())).max().item()


def ssd_case(rng, shape, dtype, return_state, packed) -> float:
    """One sweep case of the SSD kernel against its plain version."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_scan_ref
    x, dt, A, B, C, D = _ssd_inputs(rng, *shape, dtype, packed)
    route = ("cuda cores" if dtype == torch.float32 else "tensor cores, "
             + ("TMA" if ssd.tma_route(x, B, C) else "threads' loads"))
    out = ssd.ssd_fwd(x, dt, A, B, C, D, return_state=return_state)
    want = ssd_scan_ref(x, dt, A, B, C, D, return_state=return_state)
    torch.cuda.synchronize()
    y, y_ref = (out[0], want[0]) if return_state else (out, want)
    check(bool(torch.isfinite(y).all()), f"SSD kernel output not finite "
          f"at {shape}")
    err = _rel(y, y_ref)
    check(err <= SSD_TOL[dtype], f"SSD y at {shape} {dtype}: {err:.3e} > "
          f"{SSD_TOL[dtype]}")
    serr = 0.0
    if return_state:
        serr = _rel(out[1], want[1])
        check(serr <= SSD_STATE_TOL, f"SSD final state at {shape} {dtype}: "
              f"{serr:.3e} > {SSD_STATE_TOL}")
    print(f"  ssd {shape} {str(dtype)[6:]} state={return_state} "
          f"packed={packed} ({route}): |y-ref|/(1+|ref|) {err:.3e}"
          + (f", state {serr:.3e}" if return_state else ""))
    return err


def phase_ssd_sweep(rng) -> None:
    print("SSD kernel vs plain version (relative to 1 + |ref|: f32 tol "
          f"{SSD_TOL[torch.float32]:.0e}, bf16 tol "
          f"{SSD_TOL[torch.bfloat16]:.0e}, state tol {SSD_STATE_TOL:.0e})")
    for i, shape in enumerate(SSD_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            for return_state in (False, True):
                # every other shape with x, B, C sliced from one tensor
                ssd_case(rng, shape, dtype, return_state, packed=i % 2 == 1)
    ssd_case(rng, SSD_LONG, torch.bfloat16, True, packed=True)


def _ssd_split(fn, iters: int) -> dict:
    """Device ms a call of ``fn`` by the name of each SSD kernel it
    launches, from ``torch.profiler`` over ``iters`` warm calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    _, per = _device_ms(prof)
    split = {k: v / iters for k, v in per.items() if "ssd_" in k}
    check(bool(split), "the profiler saw no SSD kernel")
    return split


def phase_ssd_main(rng) -> dict:
    """The kernel at mamba2-130m's training and prefill shape, with x, B
    and C sliced from one tensor as the model passes them."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_scan_ref
    b, s, h, p, n = SSD_MAIN
    x, dt, A, B, C, D = _ssd_inputs(rng, b, s, h, p, n, torch.bfloat16,
                                    packed=True)
    check(ssd.tma_route(x, B, C), "the main shape does not take TMA")
    y, state = ssd.ssd_fwd(x, dt, A, B, C, D, return_state=True)
    y_ref, state_ref = ssd_scan_ref(x, dt, A, B, C, D, return_state=True)
    err = (y.float() - y_ref.float()).abs().max().item()
    rel = _rel(y, y_ref)
    serr = _rel(state, state_ref)
    check(rel <= SSD_TOL[torch.bfloat16] and serr <= SSD_STATE_TOL,
          f"SSD at the main shape: y {rel:.3e}, state {serr:.3e}")
    ms = time_ms(lambda: ssd.ssd_fwd(x, dt, A, B, C, D), iters=20)
    split = _ssd_split(lambda: ssd.ssd_fwd(x, dt, A, B, C, D), iters=10)
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C, D), iters=3,
                       warmup=1)
    Q, nc = ssd.CHUNK, -(-s // ssd.CHUNK)
    # C B^T once per (b, chunk), the intra-chunk product, the inter-chunk
    # product and the chunk states
    flops = (2 * b * nc * Q * Q * n + 2 * b * h * nc * Q * Q * p
             + 2 * 2 * b * h * s * p * n)
    nbytes = (2 * (2 * b * s * h * p) + 4 * b * s * h + 2 * (2 * b * s * n)
              + 2 * 4 * h)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"ssd main shape {SSD_MAIN} bf16: kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s), "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); max|y-ref| "
          f"{err:.3e} (relative {rel:.3e}), state {serr:.3e}; no single "
          "PyTorch call computes the scan")
    for name, k_ms in split.items():
        print(f"  ssd split: {k_ms:.4f} ms ({100 * k_ms / ms:.1f}% of the "
              f"event-timed call)  {name[:90]}")
    print(f"  ssd split: {sum(split.values()):.4f} ms in {len(split)} "
          "kernels (torch.profiler, device time a call)")
    return {"name": "ssd_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_fwd.cu",
            "replaces": "src/repro/kernels/ssd_pallas.py:30",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _ssd_grad_case(rng, shape, chunk, dtype, A=None) -> float:
    """Worst per-leaf gradient error of ops.ssd_scan on CUDA tensors
    against autograd through the sequential oracle; every gradient must
    be finite."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_reference
    leaves = [t.detach().requires_grad_()
              for t in _ssd_inputs(rng, *shape, dtype, A=A)]
    g = _randn(rng, shape[:4], torch.float32)
    y = ops.ssd_scan(*leaves, chunk=chunk)
    check("SSDScan" in type(y.grad_fn).__name__,
          f"CUDA SSD output has grad_fn {y.grad_fn}")
    got = torch.autograd.grad((y.float() * g).sum(), leaves)
    want = torch.autograd.grad((ssd_reference(*leaves).float() * g).sum(),
                               leaves)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, w in zip(("x", "dt", "A", "B", "C", "D"), got, want):
        check(bool(torch.isfinite(a).all()), f"d{name} not finite at "
              f"{shape} chunk {chunk} {dtype}")
        err = ((a.float() - w.float()).abs().max()
               / w.float().abs().max().clamp_min(1e-30)).item()
        worst = max(worst, err)
        check(err <= SSD_GRAD_TOL[dtype], f"d{name} {shape} chunk {chunk} "
              f"{dtype}: {err:.3e} > {SSD_GRAD_TOL[dtype]}")
    return worst


def phase_ssd_grads(rng) -> None:
    print("SSD gradients: ops.ssd_scan (kernel forward, ssd_chunked "
          "backward) vs autograd through ssd_reference (max |dg| / max|g| "
          f"per leaf, f32 tol {SSD_GRAD_TOL[torch.float32]:.0e}, bf16 tol "
          f"{SSD_GRAD_TOL[torch.bfloat16]:.0e})")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape, chunk in SSD_GRAD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            worst[dtype] = max(worst[dtype],
                               _ssd_grad_case(rng, shape, chunk, dtype))
    print(f"  worst: f32 {worst[torch.float32]:.3e}, bf16 "
          f"{worst[torch.bfloat16]:.3e} over {2 * len(SSD_GRAD_SWEEP)} cases")
    # ROADMAP C3: chunk 128 at the model's init (A_log = 0, so A = -1),
    # where the JAX package's chunked gradients are NaN
    err = _ssd_grad_case(rng, (1, 256, 2, 8, 16), 128, torch.float32, A=-1.0)
    print(f"  C3 case (1, 256, 2, 8, 16) chunk 128 A=-1 f32: all gradients "
          f"finite, worst {err:.3e}")


def phase_mamba_train() -> int:
    """mamba2-130m's training entry point at full width; returns SSD
    launches."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model import build_model
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    run = train_mod.run(MAMBA, steps=TRAIN_STEPS, batch=MAMBA_B,
                        seq=MAMBA_S, dtype="bfloat16", device="cuda", seed=0,
                        log_every=1)
    flash, kl, launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(run.summary())
    print(f"train {MAMBA} peak device memory {peak:.2f} GiB; loop "
          f"{run.seconds:.2f} s; {run.n_params / 1e6:.1f}M parameters")
    res, cfg = run.result, run.cfg
    check(_finite(res.losses) and _finite(res.grad_norms),
          f"non-finite loss or grad norm: {res.losses}, {res.grad_norms}")
    want = TRAIN_STEPS * cfg.num_layers * 2
    check(launches == run.ssd_launches == want,
          f"SSD launched {launches} times in training, expected steps x "
          f"layers x 2 = {want}")
    check(flash == kl == 0, "training mamba launched flash or distill_kl")
    changed = _changed_leaves(res.params,
                              build_model(cfg, device="cuda", seed=0)
                              .param_tree())
    print(f"train {MAMBA}: {sum(changed.values())} of {len(changed)} "
          f"parameter leaves changed")
    check(all(changed.values()), "parameters that did not change: "
          f"{[k for k, v in changed.items() if not v]}")
    return launches


def phase_mamba_serve(rng) -> int:
    """mamba2-130m's serving entry point at full width (counted), then the
    same batch warm; returns SSD launches."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = serve_mod.serve(MAMBA, batch=MAMBA_B, prompt_len=MAMBA_S, gen=32,
                          dtype="bfloat16", device="cuda", seed=0)
    flash, kl, launches = read_counts()
    cfg = res.cfg
    print(res.summary())
    print(f"serve {MAMBA} peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(res.prefill_ssd_launches == launches == cfg.num_layers,
          f"prefill launched SSD {res.prefill_ssd_launches} times, "
          f"expected {cfg.num_layers}")
    check(res.decode_ssd_launches == 0 and flash == kl == 0,
          "decode launched the SSD kernel, or serving launched another")
    check(res.logits_finite, "non-finite logits")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "generated token outside the vocabulary")
    model = build_model(cfg, device="cuda", seed=0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MAMBA_B, MAMBA_S))).cuda()
    serve_mod.generate(model, prompts, 2)                      # warm-up
    print("warm " + serve_mod.generate(model, prompts, 32).summary())
    return launches


def phase_mamba_consistency(rng) -> None:
    """Prefill of S-2 tokens (a ragged last chunk) and 2 decode steps
    against forward, at full width, 4 layers, float32."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(MAMBA).replace(num_layers=4, dtype="float32")
    model = build_model(cfg, device="cuda", seed=1)
    B, S = 2, MAMBA_S
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).cuda()
    full = model({"tokens": tokens})
    logits, cache = model.prefill({"tokens": tokens[:, :S - 2]},
                                  extra_cache=2)
    errs = [(logits - full[:, S - 3]).abs().max().item()]
    for pos in (S - 2, S - 1):
        logits, cache = model.decode(cache, tokens[:, pos:pos + 1], pos)
        errs.append((logits - full[:, pos]).abs().max().item())
    scale = full.abs().max().item()
    # float32 with TF32 off: the kernel's chunked sums and decode's
    # recurrence add the same terms in other orders; 1e-3 is far above
    # that and far below what a wrong state, decay or conv window moves
    tol = 1e-3
    print(f"consistency {cfg.name} d_model={cfg.d_model} layers=4 f32, "
          f"S={S}: prefill/decode vs forward max|diff| "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:.0e}; max "
          f"|logit| {scale:.2f})")
    check(max(errs) <= tol, "prefill + decode disagrees with forward")


def phase_mamba_grad_consistency(rng) -> None:
    """One mamba2-130m train step's gradients at full width (2 layers,
    float32) on the kernel against the same step on CPU copies, at chunk
    128 from the model's init (A = -1): ROADMAP C3's case."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    cfg = get_config(MAMBA).replace(num_layers=2, dtype="float32")
    # every leaf in float32 (norm scales are bf16 by spec)
    init = tree_map(lambda p: p.detach().float(),
                    build_model(cfg, device="cuda", seed=0).param_tree())
    B, S = 2, 256
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "loss_mask": torch.from_numpy(
                 (rng.random((B, S)) < 0.9).astype(np.float32))}

    def grads(device):
        ps = tree_map(lambda p: p.to(device).requires_grad_(), init)
        model = build_model(cfg, ps, device=device)
        loss, _ = model.loss({k: v.to(device) for k, v in batch.items()},
                             params=ps)
        return loss, torch.autograd.grad(loss, tree_leaves(ps))

    reset_counts()
    loss_g, g_gpu = grads("cuda")
    launches = read_counts()
    check(launches == (0, 0, cfg.num_layers * 2),
          f"the CUDA step launched (flash, KL, SSD) = {launches}")
    loss_c, g_cpu = grads("cpu")
    check(read_counts() == launches, "the CPU step launched a kernel")
    check(all(bool(torch.isfinite(g).all()) for g in g_gpu),
          "non-finite gradient on the card")
    rel = max(((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
              .item() for a, b in zip(g_gpu, g_cpu))
    # float32 with TF32 off on both; the card's forward is the kernel's
    # 64-token chunks, the CPU's ssd_chunked at 128: 1e-3 relative per
    # leaf is far above their rounding and far below a wrong term
    tol = 1e-3
    print(f"gradient consistency {cfg.name} 2 layers f32 B={B} S={S}: loss "
          f"{loss_g.item():.6f} (CUDA) vs {loss_c.item():.6f} (CPU); max "
          f"per-leaf |dg| / max|g| {rel:.3e} (tol {tol:.0e}) over "
          f"{len(g_cpu)} leaves, all finite")
    check(abs(loss_g.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item()),
          "mamba loss differs between the card and the CPU")
    check(rel <= tol, "mamba gradients differ between the card and the CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    phase_build()
    phase_sweep(rng)
    flash_at = {"serve": phase_flash_shape(rng, PREFILL),
                "train_distill": phase_flash_shape(rng, TRAIN_ATTN)}
    phase_flash_grads(rng)
    phase_kl_sweep(rng)
    kl = phase_kl_main(rng)
    phase_ssd_sweep(rng)
    ssd = phase_ssd_main(rng)
    phase_ssd_grads(rng)
    free()
    serve_launches = phase_serve()
    free()
    phase_profile(rng)
    free()
    phase_consistency(rng)
    free()
    train_launches = phase_train()
    free()
    phase_train_trace()
    free()
    distill_launches, kl_launches = phase_distill()
    free()
    phase_grad_consistency(rng)
    free()
    mamba_train_launches = phase_mamba_train()
    free()
    phase_train_trace(MAMBA, MAMBA_B, MAMBA_S)
    free()
    mamba_serve_launches = phase_mamba_serve(rng)
    free()
    phase_mamba_consistency(rng)
    free()
    phase_mamba_grad_consistency(rng)
    paths = (f"serve {ARCH}", f"train {TRAIN_ARCH}", f"distill {TRAIN_ARCH}",
             f"train {MAMBA}", f"serve {MAMBA}")
    per_path = {
        "flash": (serve_launches, train_launches, distill_launches, 0, 0),
        "kl": (0, 0, kl_launches, 0, 0),
        "ssd": (0, 0, 0, mamba_train_launches, mamba_serve_launches)}
    flash = flash_entry(flash_at)
    for name, entry in (("flash", flash), ("kl", kl), ("ssd", ssd)):
        entry["launches"] = sum(per_path[name])
        entry["launches_per_path"] = dict(zip(paths, per_path[name]))
    print(f"chip_smoke total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [flash, kl, ssd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
