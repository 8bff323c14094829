"""The sharded serving steps on spawned gloo ranks:
``train.step.build_prefill_step`` and ``build_decode_step``.

    python tests/torch_drivers/driver_serving.py WORLD IN.npz OUT

For each case of :data:`CASES` (``data`` x ``model`` ranks, the first of
the world; the others skip it), from ``<case>/params/<path>`` (float32,
cast back to each leaf's dtype), the prompt ``<case>/tokens`` [B, S]
(whisper's with ``<case>/frames``) and
the decode tokens ``<case>/dec<i>`` [B, 1]: each rank takes its parameter
and batch blocks, runs the prefill step and :data:`DECODES` decode steps
at positions S, S + 1, ..., and writes ``<case>/prefill/logits``,
``<case>/prefill/cache/<path>``, ``<case>/dec<i>/logits`` and
``<case>/decode/cache/<path>`` (its blocks) to ``OUT.<rank>.npz``.

Prints ``DRIVER_OK serving``.  Imports no ``jax`` and nothing of
``repro``.
"""
import sys

import numpy as np
import torch

from dist_util import flat, nest, spawn
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.types import ParallelConfig, ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.common import tree_like, tree_map
from repro_torch.models.model import build_model, model_specs
from repro_torch.train import step as step_mod

#: (name, arch, config overrides, data, model)
CASES = [
    ("g_d2m2", "granite-3-8b", {}, 2, 2),
    ("g_d1m4", "granite-3-8b", {}, 1, 4),
    ("g20_d2m2", "granite-20b", {}, 2, 2),
    ("mix_d2m2", "mixtral-8x22b", {}, 2, 2),
    ("m2_d2m2", "mamba2-130m", {}, 2, 2),
    ("w_d2m2", "whisper-small", {}, 2, 2),
]
B, S, DECODES = 4, 40, 4


def config(arch: str, over: dict):
    return get_reduced(arch).replace(dtype="float32", **over)


def work(rank, world, in_path, out):
    arrays = np.load(in_path)
    res = {}
    for name, arch, over, d, m in CASES:
        mesh = shd.section_mesh(range(d * m), ParallelConfig(dp=d, tp=m))
        if rank >= d * m:
            continue
        cfg = config(arch, over)
        full = _cast(tree_like(model_specs(cfg), params_from_numpy(
            nest(arrays, f"{name}/params/"), device="cpu")),
            model_specs(cfg))
        model = build_model(cfg, full, device="cpu")
        pstep, specs = step_mod.build_prefill_step(
            model, mesh, ShapeConfig("p", "prefill", S, B))
        dstep, dspecs = step_mod.build_decode_step(
            model, mesh, ShapeConfig("d", "decode", S, B))
        params = shd.shard_tree(full, tree_like(full, specs["params"]), mesh)
        tokens = torch.from_numpy(arrays[f"{name}/tokens"]).long()
        batch = {"tokens": shd.shard(tokens, specs["batch"]["tokens"],
                                     mesh)}
        if cfg.family == "audio":
            batch["frames"] = shd.shard(
                torch.from_numpy(arrays[f"{name}/frames"]),
                specs["batch"]["frames"], mesh)
        logits, cache = pstep(params, batch)
        res[f"{name}/prefill/logits"] = logits.float().numpy()
        # a copy: decode writes the cache in place
        res.update(flat(tree_map(torch.clone, cache),
                        f"{name}/prefill/cache/"))
        for i in range(DECODES):
            tok = torch.from_numpy(arrays[f"{name}/dec{i}"]).long()
            logits, cache = dstep(params, cache,
                                  shd.shard(tok, dspecs["token"], mesh),
                                  S + i)
            res[f"{name}/dec{i}/logits"] = logits.float().numpy()
        res.update(flat(cache, f"{name}/decode/cache/"))
    np.savez(f"{out}.{rank}.npz", **res)


def _cast(tree, specs):
    if isinstance(tree, dict):
        return {k: _cast(v, specs[k]) for k, v in tree.items()}
    return tree.to(specs.dtype)


if __name__ == "__main__":
    world = int(sys.argv[1])
    spawn(work, world, *sys.argv[2:4])
    print("DRIVER_OK serving")
