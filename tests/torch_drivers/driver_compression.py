"""Compression driver: the port's compressed all-reduce on spawned gloo
ranks.

    python tests/torch_drivers/driver_compression.py WORLD IN.npz OUT.npz

``IN.npz`` holds ``xs`` [WORLD, N], ``g_const`` [WORLD, M] and the leaves
``wire/<name>`` of a small tree.  Rank r reduces ``xs[r]`` with
``compressed_psum_bf16``, ``compressed_psum_int8`` and the float32
``psum``; feeds ``g_const[r]`` through 20 steps of int8 error feedback
(``ef_compress_tree``, mean) and sums what it emits; and reduces the wire
tree once by each method with the wire counters reset before.  The ranks'
results must agree.  Rank 0 writes ``bf16``, ``int8``, ``exact``,
``ef_emitted`` (float64), ``ef_residual_max``, and per method the
counters' bytes beside ``wire_bytes`` of the tree in float32
(``wire/<method>/<counter>``, ``wire/payload_f32``) to ``OUT.npz``.
Prints ``DRIVER_OK compression``.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from dist_util import nest, spawn
from repro_torch.optim import compression as gcomp

EF_STEPS = 20


def _agree(t: torch.Tensor, what: str, world: int) -> None:
    every = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(every, t.contiguous())
    if not all(torch.equal(e, t) for e in every):
        raise AssertionError(f"the ranks' {what} differ")


def work(rank, world, in_path, out_path):
    arrays = np.load(in_path)
    x = torch.from_numpy(arrays["xs"][rank])
    out = {"bf16": gcomp.compressed_psum_bf16(x),
           "int8": gcomp.compressed_psum_int8(x),
           "exact": gcomp.psum(x)}
    for k, v in out.items():
        _agree(v, k, world)

    g = {"w": torch.from_numpy(arrays["g_const"][rank])}
    ef = gcomp.ef_init(g)
    emitted = torch.zeros(g["w"].shape, dtype=torch.float64)
    for _ in range(EF_STEPS):
        red, ef = gcomp.ef_compress_tree(g, ef, None, "int8")
        emitted += red["w"].double()
    _agree(emitted, "emitted sums", world)
    res = ef.residual["w"].abs().max().reshape(1)
    dist.all_reduce(res, op=dist.ReduceOp.MAX)
    out.update(ef_emitted=emitted, ef_residual_max=res)

    tree = {k: torch.from_numpy(v) for k, v in nest(arrays, "wire/").items()}
    for method in gcomp.METHODS:
        gcomp.reset_wire_counts()
        gcomp.ef_compress_tree(tree, gcomp.ef_init(tree), None, method)
        for name, n in gcomp.wire_counts().items():
            out[f"wire/{method}/{name}"] = torch.tensor(n)
    out["wire/payload_f32"] = torch.tensor(gcomp.wire_bytes(tree, "none"))
    if rank == 0:
        np.savez(out_path, **{k: v.numpy() for k, v in out.items()})


if __name__ == "__main__":
    spawn(work, int(sys.argv[1]), sys.argv[2], sys.argv[3])
    print("DRIVER_OK compression")
