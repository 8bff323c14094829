#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); it builds the port's
CUDA kernels from the sources in this checkout.  Phases:

1. Card and build: the card's name and power limit from ``nvidia-smi``;
   the flash-attention kernel built from ``kernels/csrc/flash_fwd.cu``.
2. The kernel against its plain version (``kernels/ref.py``) on the card,
   over a sweep of shapes, masks and dtypes, and at the serving prefill
   shape, where the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` are timed.
3. The main path: ``repro_torch.launch.serve.serve`` runs granite-3-8b at
   full width in bf16 (random weights from a seed), batch 4, prompt 2048,
   32 generated tokens; the kernel must be launched once per layer in
   prefill, every token in the vocabulary and every logit finite.
   Then a warm run of the same model and shapes is timed, and traced with
   ``torch.profiler`` for device busy time by kernel.
4. Consistency at full width: granite-3-8b cut to 4 layers, float32;
   prefill of S-2 tokens then 2 decode steps must give ``forward``'s
   logits.  Decode attends with plain PyTorch and forward with the kernel.
5. A ``{"kernels": [...]}`` line with each kernel's launches on the main
   path, error and times, then the ``{"ok": true, ...}`` line.

Any failed check raises, so the script exits non-zero and prints no
result.  It exits non-zero without a CUDA card, and when run from a
directory that holds no ``src/repro_torch``.
"""
from __future__ import annotations

import gc
import json
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
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
# tests/test_kernels_flash.py's sweep (B, S, T, H, KV, D), plus a ragged length
SWEEP = [(2, 128, 128, 4, 2, 16), (1, 256, 256, 8, 8, 32),
         (2, 128, 64, 4, 1, 16), (1, 64, 64, 6, 3, 8),
         (2, 200, 200, 4, 2, 64)]
MODES = [(True, 0), (False, 0), (True, 32)]
PREFILL = (4, 2048, 2048, 32, 8, 128)    # granite-3-8b serving prefill
ARCH = "granite-3-8b"


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


def phase_build() -> None:
    from repro_torch.kernels import _build
    print(f"card: {card()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    built = _build.build("flash_fwd")
    print(f"build flash_fwd: {built.seconds:.1f} s -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
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


def phase_prefill_shape(rng) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    B, S, T, H, KV, D = PREFILL
    q, k, v, o, err = run_case(rng, PREFILL, torch.bfloat16, True, 0)
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
    print(f"prefill shape {PREFILL} bf16 causal: kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
          f"sdpa {library_ms:.3f} ms (|sdpa-kernel| {lib_err:.3e}), "
          f"bound {bound_ms:.4f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:51",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def phase_serve() -> int:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_mod
    torch.cuda.reset_peak_memory_stats()
    B, S, _, _, _, _ = PREFILL
    fa.flash_fwd.launches = 0
    t0 = time.perf_counter()
    res = serve_mod.serve(ARCH, batch=B, prompt_len=S, gen=32,
                          dtype="bfloat16", device="cuda", seed=0)
    wall = time.perf_counter() - t0
    launches = fa.flash_fwd.launches
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    phase_build()
    phase_sweep(rng)
    entry = phase_prefill_shape(rng)
    gc.collect()
    torch.cuda.empty_cache()
    entry["launches"] = phase_serve()
    gc.collect()
    torch.cuda.empty_cache()
    phase_profile(rng)
    gc.collect()
    torch.cuda.empty_cache()
    phase_consistency(rng)
    print(f"chip_smoke total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
