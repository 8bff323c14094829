"""Deterministic synthetic data (``repro/data/synthetic.py``): token
streams, mixed-modality batches and audio (frame-embedding) batches.

The numpy stream is the JAX package's, draw for draw, so one seed gives
the same batches on both sides; the batches are torch tensors on the
device the caller names (tokens, labels and image positions int64, the
index dtype of PyTorch, where the JAX package uses int32).

The multimodal generator reproduces the data regime the paper targets
(§2.1/§4.1): a vision:text sample mix; text-only samples bypass the
vision section entirely.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np
import torch


def _lm_ngram_tokens(rng: np.random.Generator, batch: int, seq: int,
                     vocab: int) -> np.ndarray:
    """Markov-ish synthetic tokens so cross-entropy is *learnable*: token
    t+1 = (a·t + b) mod vocab with per-sequence (a, b) plus noise."""
    a = rng.integers(1, 17, (batch, 1))
    b = rng.integers(0, vocab, (batch, 1))
    t0 = rng.integers(0, vocab, (batch, 1))
    toks = [t0]
    for _ in range(seq):
        nxt = (a * toks[-1] + b) % vocab
        flip = rng.random((batch, 1)) < 0.1
        noise = rng.integers(0, vocab, (batch, 1))
        toks.append(np.where(flip, noise, nxt))
    return np.concatenate(toks, axis=1)


def lm_batches(*, batch: int, seq_len: int, vocab: int, seed: int = 0,
               device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    while True:
        toks = torch.from_numpy(_lm_ngram_tokens(rng, batch, seq_len, vocab))
        yield {
            "tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device),
            "loss_mask": torch.ones((batch, seq_len), dtype=torch.float32,
                                    device=device),
        }


def routed_lm_batches(*, batch: int, seq_len: int, vocab: int,
                      specialist_ratio: float = 0.3, seed: int = 0,
                      device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """LM batches with a per-sample ``domain`` flag (1 = specialist
    domain, int32): the data-dependent activation signal for multi-teacher
    distillation — specialist-domain samples route to the second teacher
    section, everything else bypasses it."""
    rng = np.random.default_rng(seed)
    while True:
        toks = torch.from_numpy(_lm_ngram_tokens(rng, batch, seq_len, vocab))
        domain = (rng.random(batch) < specialist_ratio).astype(np.int32)
        yield {
            "tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device),
            "loss_mask": torch.ones((batch, seq_len), dtype=torch.float32,
                                    device=device),
            "domain": torch.from_numpy(domain).to(device),
        }


@dataclass
class MultimodalSample:
    has_image: bool
    image_tokens: int          # visual tokens consumed by the LM
    vit_patches: int           # raw patches the ViT section processes


def sample_modalities(rng: np.random.Generator, n: int, *,
                      vision_ratio: float, image_tokens: int,
                      downsample: int = 4) -> List[MultimodalSample]:
    out = []
    for _ in range(n):
        has = rng.random() < vision_ratio
        out.append(MultimodalSample(
            has, image_tokens if has else 0,
            image_tokens * downsample if has else 0))
    return out


def vlm_batches(*, batch: int, seq_len: int, vocab: int, vision_ratio: float,
                image_tokens: int, patch_dim: int, downsample: int = 4,
                seed: int = 0, device="cuda"
                ) -> Iterator[Dict[str, torch.Tensor]]:
    """Mixed text/vision batches: LM inputs plus the ViT section's raw
    ``patches`` [B, K·downsample, patch_dim] (bf16, rounded to nearest
    even from the f32 draw as the JAX package's cast does; zero on text
    rows) and static-capacity image slots (``image_pos`` / ``image_valid``
    [B, K]; images lead the sequence, which carries no LM loss there)."""
    rng = np.random.default_rng(seed)
    K = image_tokens
    while True:
        toks = torch.from_numpy(_lm_ngram_tokens(rng, batch, seq_len, vocab))
        modal = sample_modalities(rng, batch, vision_ratio=vision_ratio,
                                  image_tokens=K, downsample=downsample)
        has = np.array([m.has_image for m in modal])
        patches = rng.standard_normal(
            (batch, K * downsample, patch_dim)).astype(np.float32)
        patches[~has] = 0.0
        pos = np.tile(np.arange(K)[None], (batch, 1))
        valid = np.tile(has[:, None], (1, K)).astype(np.int32)
        mask = np.ones((batch, seq_len), np.float32)
        mask[has, :K] = 0.0              # no LM loss on image positions
        yield {
            "tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device),
            "loss_mask": torch.from_numpy(mask).to(device),
            "patches": torch.from_numpy(patches).to(device=device,
                                                   dtype=torch.bfloat16),
            "image_pos": torch.from_numpy(pos).to(device),
            "image_valid": torch.from_numpy(valid).to(device),
            "has_image": torch.from_numpy(has.astype(np.int32)).to(device),
        }


def audio_batches(*, batch: int, seq_len: int, vocab: int, frames: int,
                  frame_dim: int, seed: int = 0, device="cuda"
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """Encoder-decoder batches: LM inputs plus ``frames`` [B, frames,
    frame_dim], the stubbed audio frontend's frame embeddings (bf16: the
    float64 draw rounded through float32, as the JAX package's cast
    does)."""
    rng = np.random.default_rng(seed)
    while True:
        toks = torch.from_numpy(_lm_ngram_tokens(rng, batch, seq_len, vocab))
        fr = rng.standard_normal((batch, frames, frame_dim))
        yield {
            "tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device),
            "loss_mask": torch.ones((batch, seq_len), dtype=torch.float32,
                                    device=device),
            "frames": torch.from_numpy(fr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16),
        }
