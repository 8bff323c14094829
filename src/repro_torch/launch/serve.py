"""Batched serving entry point: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --batch 4 --prompt-len 2048 --gen 32 --dtype bfloat16

Counterpart of ``repro/launch/serve.py`` with the same options, plus
``--device`` (``cuda`` by default) and ``--seed`` (weights from a seeded
``torch.Generator``, prompts from ``np.random.default_rng(seed)``).  It
prints prefill time and tokens/s, decode time per token, and how many
times the flash-attention and SSD-scan kernels were launched.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.core.types import ArchConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.model import Model, build_model

# the JAX package's presets (repro/launch/train.py)
PRESETS = {
    "lm-100m": ArchConfig(name="lm-100m", family="dense", num_layers=12,
                          d_model=768, num_heads=12, num_kv_heads=4,
                          d_ff=2048, vocab_size=32768, head_dim=64),
    "lm-20m": ArchConfig(name="lm-20m", family="dense", num_layers=6,
                         d_model=384, num_heads=6, num_kv_heads=2,
                         d_ff=1024, vocab_size=8192, head_dim=64),
}


@dataclass
class ServeResult:
    cfg: ArchConfig
    prompts: torch.Tensor           # [B, S]
    tokens: torch.Tensor            # [B, gen] greedy tokens
    logits_finite: bool             # every prefill and decode logit finite
    prefill_s: float
    decode_s: float
    prefill_launches: int           # flash kernel launches during prefill
    decode_launches: int            # ... and during decode
    prefill_ssd_launches: int       # SSD kernel launches during prefill
    decode_ssd_launches: int        # ... and during decode

    def summary(self) -> str:
        B, S = self.prompts.shape
        gen = self.tokens.shape[1]
        steps = max(gen - 1, 1)
        return (f"arch={self.cfg.name} batch={B} prompt={S} gen={gen} "
                f"dtype={self.cfg.dtype}\n"
                f"prefill: {self.prefill_s * 1e3:.1f} ms "
                f"({B * S / self.prefill_s:.0f} tok/s)\n"
                f"decode:  {self.decode_s * 1e3 / steps:.2f} ms/token "
                f"({B * (gen - 1) / max(self.decode_s, 1e-9):.0f} tok/s)\n"
                f"flash kernel launches: prefill {self.prefill_launches}, "
                f"decode {self.decode_launches}\n"
                f"ssd kernel launches: prefill {self.prefill_ssd_launches}, "
                f"decode {self.decode_ssd_launches}")


def resolve_config(arch: str, *, reduced: bool = False,
                   dtype: str = "float32") -> ArchConfig:
    if arch in PRESETS:
        cfg = PRESETS[arch]
    elif reduced:
        cfg = get_reduced(arch)
    else:
        cfg = get_config(arch)
    return cfg.replace(dtype=dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, prompts: torch.Tensor, gen: int,
             frames: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` [B, S], then ``gen - 1`` greedy decode steps.
    An encoder-decoder (``audio``) model also takes ``frames`` [B, F,
    frontend_dim], which the prefill encodes; the CLI, like the
    reference's, passes tokens only, so it cannot serve that family."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    elif model.cfg.family == "audio":
        raise ValueError(
            f"{model.cfg.name} is an encoder-decoder: generate() needs the "
            "frame embeddings `frames` [B, frontend_frames, frontend_dim] "
            "beside the prompts")
    device = prompts.device
    S = prompts.shape[1]
    _sync(device)
    n0, m0 = fa.flash_fwd.launches, ssd.ssd_fwd.launches
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, extra_cache=gen)
    out = [logits.argmax(-1)[:, None]]
    finite = torch.isfinite(logits).all()
    _sync(device)
    t_prefill = time.perf_counter() - t0
    n1, m1 = fa.flash_fwd.launches, ssd.ssd_fwd.launches
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode(cache, out[-1], S + i)
        finite &= torch.isfinite(logits).all()
        out.append(logits.argmax(-1)[:, None])
    _sync(device)
    t_decode = time.perf_counter() - t0
    return ServeResult(model.cfg, prompts, torch.cat(out, dim=1),
                       bool(finite), t_prefill, t_decode,
                       n1 - n0, fa.flash_fwd.launches - n1,
                       m1 - m0, ssd.ssd_fwd.launches - m1)


def serve(arch: str = "lm-20m", *, reduced: bool = False, batch: int = 4,
          prompt_len: int = 64, gen: int = 32, dtype: str = "float32",
          device: str = "cuda", seed: int = 0) -> ServeResult:
    """Build ``arch`` with seeded random weights and serve one batch."""
    cfg = resolve_config(arch, reduced=reduced, dtype=dtype)
    model = build_model(cfg, device=device, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)
    return generate(model, prompts, gen)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-20m",
                    help=f"preset {list(PRESETS)} or one of {ARCH_NAMES}")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, dtype=args.dtype,
                device=args.device, seed=args.seed)
    print(res.summary())
    print("sample:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
