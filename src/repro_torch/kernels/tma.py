"""The preconditions of a TMA tensor map, checked before a bf16 tensor
reaches a tensor-core kernel (``csrc/hopper.cuh::make_tensor_map``).

The driver refuses a map whose base is not 16-byte aligned, whose strides
are not 16-byte multiples (or reach 2**40 bytes), whose innermost dimension
is not contiguous, or whose dimensions exceed 2**32 elements.  A tensor
that fails one raises ``ValueError`` naming the condition: nothing pads,
copies or reroutes it.  :func:`tma_violation` is a pure function of
shape, strides, pointer and element size, so it is tested on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def tma_violation(shape: Sequence[int], strides: Sequence[int], ptr: int,
                  elem_size: int) -> Optional[str]:
    """The first TMA precondition that a tensor of this shape, strides (in
    elements), data pointer and element size breaks, or None.  A
    dimension of size 1 is never stepped, so its stride is free."""
    if ptr % 16:
        return "16-byte-aligned base"
    if shape[-1] > 1 and strides[-1] != 1:
        return "contiguous last dim"
    for size, stride in zip(shape[:-1], strides[:-1]):
        if size > 1 and (stride * elem_size) % 16:
            return "strides in 16-byte multiples"
        if size > 1 and stride * elem_size >= 2 ** 40:
            return "strides below 2**40 bytes"
    if any(size > 2 ** 32 for size in shape):
        return "dims of at most 2**32 elements"
    return None


def check_tma(name: str, x: torch.Tensor) -> None:
    """Raise ``ValueError`` if ``x`` cannot be read through a tensor map."""
    why = tma_violation(x.shape, x.stride(), x.data_ptr(), x.element_size())
    if why is not None:
        raise ValueError(
            f"{name} {tuple(x.shape)} with strides {x.stride()} cannot be "
            f"read by TMA: it needs a {why}")
