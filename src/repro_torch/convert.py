"""JAX parameter tree (as numpy arrays) -> the port's parameter tree.

The two packages share one tree layout: the same nested-dict keys, the
same shapes, the same stacked ``layers`` axis and the same einsum layouts
(``wq [d, h, hd]``, ``wo [h, hd, d]``).  Conversion is a leaf-by-leaf copy
with no transposes and no renaming.  The caller turns the JAX arrays into
numpy first (``jax.tree_util.tree_map(np.asarray, params)``), so this
module imports nothing of JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _leaf(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects; widening to
        # float32 is exact, and the cast back restores the same bits
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, *, device, dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (optionally cast to ``dtype``)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    return _leaf(tree, device, dtype)


def section_params_from_numpy(trees, devices):
    """Per-section form: ``{section: numpy tree}`` -> ``{section: tensor
    tree on devices[section]}``, the layout ``CompoundRuntime.place`` and
    ``install`` take.  The JAX ``CompoundRuntime.init`` draws one PRNG key
    per section, so parity runs carry the JAX run's trees across rather
    than re-deriving either side's initialisation."""
    return {name: params_from_numpy(tree, device=devices[name])
            for name, tree in trees.items()}
