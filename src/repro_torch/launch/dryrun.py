"""Dry-run of one (arch x shape x mesh) cell on a fake world: the port's
counterpart of ``repro/launch/dryrun.py``, which compiles a cell for 512
virtual devices and reads XLA's memory and cost analysis.

A cell runs in one process standing for one rank of a world of
``REPRO_DRYRUN_DEVICES`` ranks (default: the mesh's size): it initialises
PyTorch's fake process group (``backend="fake"``: collectives return at
once and move nothing) at that world size, builds the production mesh (or
``REPRO_DRYRUN_MESH``'s) as a ``DeviceMesh``, and under
``FakeTensorMode`` builds this rank's blocks of the parameters, optimizer
state, batch and cache as fake tensors on the ``meta`` device (shapes,
dtypes and strides, no storage), which stands for the card: the kernel
dispatch (``kernels.ops.kernel_route``) sends meta tensors down the
kernel route, as it sends CUDA tensors, on a CPU-only build too (where
PyTorch cannot index a fake CUDA tensor).  It then calls the real step
builders,
``train.step.build_train_step(..., mesh=)``, ``build_prefill_step`` or
``build_decode_step``, and runs one step under
:class:`~repro_torch.roofline.record.StepRecorder`.  On these tensors
the hand-written kernels' ops (``repro_torch::flash_fwd``,
``::flash_bwd``, ``::ssd_fwd``, ``::ssd_bwd``) give their shape
functions' outputs, so the step traces the route the card runs and
counts the kernels' own outputs.

The record has the reference's keys: ``params``, ``active_params``,
``head_pad``, ``vocab_pad``, ``memory`` (``argument_size_in_bytes``,
``output_size_in_bytes``, ``temp_size_in_bytes``, ``alias_size_in_bytes``
and the port's ``peak_bytes``: the predicted peak of live device bytes on
this rank), ``hlo`` (per-device FLOPs, un-fused bytes, ring-model wire
bytes by collective family and by dtype), ``roofline`` (on
``core.types.H100``), ``kernel_adjusted_memory_s``, ``model_flops``,
``useful_flops_ratio``, ``tokens``, and ``skipped`` for ``long_500k`` on
an arch that is not ``sub_quadratic``.  A pipeline cell records rank 0 and,
under ``last_stage``, the last stage's rank, whose programs differ.
``--sp`` (the reference's sequence-parallel residual) is an XLA layout
knob the port does not have: it is accepted and recorded as ignored.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k \\
      --mesh single --out experiments/dryrun_torch      # one cell
  python -m repro_torch.launch.dryrun --all [--mesh both]  # full sweep, one
      subprocess per cell
  REPRO_DRYRUN_TINY=1 REPRO_DRYRUN_DEVICES=8 REPRO_DRYRUN_MESH=4,2 ...
      # reduced config, seq <= 128, batch <= 8, on a 4 x 2 mesh of 8 ranks

``python -m repro_torch.roofline.report DIR`` tabulates the JSONs.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional


#: the device a dry-run's fake tensors stand on (see the module docstring)
DEVICE = "meta"


def _cell_name(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


def _mesh_dims(mesh_kind: str, pp: int, cp: int):
    """(dims, names) of ``REPRO_DRYRUN_MESH`` or the production mesh."""
    from repro_torch.launch.mesh import env_dims, production_dims
    return env_dims() or production_dims(multi_pod=mesh_kind == "multi",
                                         pp=pp, cp=cp)


def fake_world(world: int, rank: int = 0) -> None:
    """Make the fake process group of ``world`` ranks, this process being
    ``rank``, the default group (replacing another one)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() == world
                and dist.get_rank() == rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _block_shape(shape, spec, sizes) -> tuple:
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        for a in axes:
            out[d] //= sizes[a]
    return tuple(out)


def fake_blocks(tree, specs, sizes):
    """Fake tensors of the blocks of ``tree`` (meta tensors or
    ParamSpecs) under ``specs`` (call under ``FakeTensorMode``)."""
    import torch
    if isinstance(tree, dict):
        return {k: fake_blocks(v, specs[k], sizes) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not hasattr(tree, "axes"):
        return type(tree)(*(fake_blocks(getattr(tree, k), getattr(specs, k),
                                    sizes) for k in tree._fields))
    return torch.empty(_block_shape(tree.shape, specs, sizes),
                       dtype=tree.dtype, device=DEVICE)


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if hasattr(x, "element_size"))


def _record_rank(cfg, shape, mesh_kind: str, mbs: int, pp: int, cp: int,
                 world: int, rank: int, extra_cache: int = 0) -> dict:
    """One rank of one cell: its record's memory, ``hlo`` and roofline."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.types import H100, ParallelConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import Model, model_specs
    from repro_torch.optim import adamw
    from repro_torch.roofline.analysis import (collective_families,
                                               roofline_terms,
                                               wire_bytes_by_dtype)
    from repro_torch.roofline.record import record
    from repro_torch.train import step as step_mod

    fake_world(world, rank)
    dims, names = _mesh_dims(mesh_kind, pp, cp)
    mesh = make_mesh(dims, names)
    sizes = shd.mesh_shape(mesh)
    specs = model_specs(cfg)
    t0 = time.time()
    # allow_non_fake_inputs: the DeviceMesh's own rank tensor is real
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = Model(cfg, tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype, device=DEVICE),
            specs))
        if shape.kind == "train":
            parallel = ParallelConfig(
                dp=shd.axis_size(mesh, shd.dp_axes(mesh)),
                tp=sizes.get("model", 1), pp=sizes.get("pipe", 1),
                cp=sizes.get("seq", 1), mbs=mbs)
            step = step_mod.build_train_step(model, parallel, shape,
                                             mesh=mesh)
            params = fake_blocks(specs, step.shardings["params"], sizes)
            opt = fake_blocks(adamw.state_specs(model.param_shapes()),
                          step.shardings["opt"], sizes)
            batch = fake_blocks(model.input_specs(shape),
                                step.shardings["batch"], sizes)
            parts = {"params": params, "opt": opt, "batch": batch}
            out, stats = record(step, params, opt, batch, 0)
        elif shape.kind == "prefill":
            step, sh = step_mod.build_prefill_step(model, mesh, shape,
                                                   extra_cache=extra_cache)
            params = fake_blocks(specs, sh["params"], sizes)
            batch = fake_blocks(model.input_specs(shape), sh["batch"], sizes)
            parts = {"params": params, "batch": batch}
            out, stats = record(step, params, batch)
        else:
            step, sh = step_mod.build_decode_step(model, mesh, shape)
            params = fake_blocks(specs, sh["params"], sizes)
            cache = fake_blocks(model.cache_specs(shape), sh["cache"], sizes)
            token = fake_blocks(model.input_specs(shape),
                                {"token": sh["token"]}, sizes)["token"]
            parts = {"params": params, "cache": cache, "token": token}
            out, stats = record(step, params, cache, token,
                                shape.seq_len - 1)
        del out
        stats.memory["argument_parts"] = {k: _nbytes(v)
                                          for k, v in parts.items()}
    return {"rank": rank, "record_s": time.time() - t0,
            "memory": stats.memory,
            "hlo": {"flops_per_device": stats.flops,
                    "hbm_bytes_per_device": stats.hbm_bytes,
                    "kernel_bytes_per_device": stats.kernel_bytes,
                    "collective_bytes_per_device":
                        collective_families(stats),
                    "wire_bytes_by_dtype": wire_bytes_by_dtype(stats),
                    "transcendental_per_device": stats.transcendental,
                    "ops": stats.ops},
            "roofline": roofline_terms(stats, hw=H100),
            "_stats": stats, "_mesh": mesh}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             mbs: int = 1, sp: bool = False, pp: int = 1,
             cp: int = 1, batch: Optional[int] = None,
             seq: Optional[int] = None, extra_cache: int = 0) -> dict:
    """One cell -> its record (see the module docstring).  ``batch`` and
    ``seq`` replace the shape's global batch and sequence length (a step
    measured on the card at its own size), ``extra_cache`` is the prefill
    step's (``train.step.build_prefill_step``)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.types import H100, SHAPES, ShapeConfig
    from repro_torch.dist.sharding import head_pad_for

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if os.environ.get("REPRO_DRYRUN_TINY"):
        cfg = reduce_config(cfg)
        shape = ShapeConfig(shape.name, shape.kind, min(shape.seq_len, 128),
                            min(shape.global_batch, 8))
    if batch is not None or seq is not None:
        shape = ShapeConfig(shape.name, shape.kind,
                            seq if seq is not None else shape.seq_len,
                            batch if batch is not None
                            else shape.global_batch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "params": cfg.total_params(), "active_params": cfg.active_params()}
    if sp:
        rec["sequence_parallel"] = (
            "ignored: an XLA activation-layout knob with no counterpart in "
            "the port (ROADMAP.md, not ported on purpose)")
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec["skipped"] = ("pure full-attention arch: 500K-token decode "
                          "needs sub-quadratic attention (DESIGN.md "
                          "§Arch-applicability)")
        return rec
    dims, names = _mesh_dims(mesh_kind, pp, cp)
    n_dev = 1
    for d in dims:
        n_dev *= d
    world = int(os.environ.get("REPRO_DRYRUN_DEVICES", n_dev))
    m = dict(zip(names, dims)).get("model", 1)
    pad = head_pad_for(cfg, m)
    if pad:
        cfg = cfg.replace(head_pad=pad)
        rec["head_pad"] = pad
    vpad = (-cfg.vocab_size) % m
    if vpad:
        cfg = cfg.replace(vocab_pad=vpad)
        rec["vocab_pad"] = vpad

    rec.update(global_batch=shape.global_batch, seq_len=shape.seq_len,
               mbs=mbs)
    got = _record_rank(cfg, shape, mesh_kind, mbs, pp, cp, world, 0,
                       extra_cache)
    stats, mesh = got.pop("_stats"), got.pop("_mesh")
    rec["world"] = world
    rec["record_s"] = got["record_s"]
    print("memory:", got["memory"])
    print("flops per device:", got["hlo"]["flops_per_device"])
    pipe = dict(zip(names, dims)).get("pipe", 1)
    if shape.kind == "train" and pipe > 1:
        idx = [0] * len(dims)
        idx[list(names).index("pipe")] = pipe - 1
        last = int(mesh.mesh[tuple(idx)])
        lst = _record_rank(cfg, shape, mesh_kind, mbs, pp, cp, world, last)
        lst.pop("_stats"), lst.pop("_mesh")
        rec["last_stage"] = lst
        fake_world(world, 0)
    if shape.kind == "decode":
        tokens = shape.global_batch
        flops_per_tok = 2 * cfg.active_params()
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        flops_per_tok = 2 * cfg.active_params()
    else:
        tokens = shape.global_batch * shape.seq_len
        flops_per_tok = 6 * cfg.active_params()
    model_flops = flops_per_tok * tokens
    total = stats.flops * n_dev
    # the kernel ops' recorded bytes replaced by the analytic kernel IO
    # (forward and, in training, the recompute and the backward)
    kio = _analytic_kernel_io(cfg, shape, n_dev)
    adj = max(stats.hbm_bytes - stats.kernel_bytes, 0.0) + kio
    rec.update({
        "devices": n_dev,
        "memory": got["memory"],
        "hlo": got["hlo"],
        "roofline": got["roofline"],
        "kernel_adjusted_memory_s": adj / H100.hbm_bandwidth,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / total if total else 0.0,
        "tokens": tokens,
    })
    print("roofline:", json.dumps(rec["roofline"]))
    print("useful_flops_ratio:", rec["useful_flops_ratio"])
    return rec


def _analytic_kernel_io(cfg, shape, n_dev: int, *, kl=()) -> float:
    """Per-device bytes the flash/SSD kernels move: q/k/v reads and the o
    write, forward plus recompute and backward (about 3x the forward; the
    flash backward is the ``repro_torch::flash_bwd`` kernel op), per
    attention layer per token on this device (the reference's).  ``kl``:
    the distillation-KL kernel's calls on this device, each ``(calls,
    tokens, d_s, d_t, vocab)``: a call reads the [tokens, d_s] and
    [tokens, d_t] hidden states and the [d_s, V] and [d_t, V] output
    layers once, forward only (its backward is plain PyTorch, recorded
    as such)."""
    io = sum(calls * (tokens + vocab) * (d_s + d_t) * 4.0
             for calls, tokens, d_s, d_t, vocab in kl)
    if shape.kind == "decode":
        return io
    tokens_per_dev = shape.global_batch * shape.seq_len / max(n_dev, 1)
    attn_layers = sum(1 for i in range(cfg.num_layers)
                      if cfg.is_attn_layer(i)) + cfg.encoder_layers
    H = max(cfg.num_heads + cfg.head_pad, 1)
    KV = max(cfg.num_kv_heads, 1)
    hd = cfg.hd if cfg.num_heads else 0
    per_tok = (H + 2 * KV + H) * hd * 4.0        # q,k,v read + o write, fp32
    mult = 3.0 if shape.kind == "train" else 1.0
    io += tokens_per_dev * attn_layers * per_tok * mult
    if cfg.family in ("ssm", "hybrid"):
        ssm_layers = sum(1 for i in range(cfg.num_layers)
                         if not cfg.is_attn_layer(i))
        d_in = cfg.ssm_expand * cfg.d_model
        io += tokens_per_dev * ssm_layers * (2 * d_in + 2 * cfg.ssm_state) \
            * 4.0 * mult
    return io


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mbs", type=int, default=1)
    ap.add_argument("--sp", action="store_true",
                    help="accepted and recorded as ignored (an XLA layout "
                         "knob)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages: carve a pipe axis out of the "
                         "data axis (train cells run the GPipe loss)")
    ap.add_argument("--cp", type=int, default=1,
                    help="context parallelism: carve a seq axis out of "
                         "the data axis (train cells run cp_attention)")
    ap.add_argument("--batch", type=int, default=None,
                    help="replace the shape's global batch")
    ap.add_argument("--seq", type=int, default=None,
                    help="replace the shape's sequence length")
    ap.add_argument("--extra-cache", type=int, default=0,
                    help="prefill cells: decode slots beyond the prompt")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--force", action="store_true",
                    help="recompute cells that already have results")
    args = ap.parse_args()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if not args.all:
        name = _cell_name(args.arch, args.shape, args.mesh)
        try:
            rec = run_cell(args.arch, args.shape, args.mesh, out_dir,
                           mbs=args.mbs, sp=args.sp, pp=args.pp,
                           cp=args.cp, batch=args.batch, seq=args.seq,
                           extra_cache=args.extra_cache)
        except Exception:
            rec = {"arch": args.arch, "shape": args.shape,
                   "mesh": args.mesh, "error": traceback.format_exc()}
            (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
            print(rec["error"], file=sys.stderr)
            sys.exit(1)
        (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=2))
        print(f"wrote {out_dir / (name + '.json')}")
        return

    # sweep: one subprocess per cell
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.core.types import SHAPES
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, m) for a in ARCH_NAMES for s in SHAPES for m in meshes]
    failures = []
    for a, s, m in cells:
        name = _cell_name(a, s, m)
        path = out_dir / f"{name}.json"
        if path.exists() and not args.force:
            try:
                if "error" not in json.loads(path.read_text()):
                    print(f"skip (done): {name}")
                    continue
            except ValueError:
                pass
        print(f"=== {name} ===", flush=True)
        t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", a, "--shape", s, "--mesh", m, "--out",
                 str(out_dir), "--mbs", str(args.mbs), "--pp", str(args.pp),
                 "--cp", str(args.cp)],
                timeout=args.timeout, capture_output=True, text=True)
            rc, err = proc.returncode, proc.stderr
        except subprocess.TimeoutExpired:
            rc, err = -1, f"timed out after {args.timeout} s"
        dur = time.time() - t0
        if rc != 0:
            failures.append(name)
            path.write_text(json.dumps(
                {"arch": a, "shape": s, "mesh": m,
                 "error": err[-4000:]}, indent=2))
            print(f"FAIL ({dur:.0f}s): {name}\n{err[-2000:]}", flush=True)
        else:
            print(f"ok ({dur:.0f}s): {name}", flush=True)
    print(f"sweep done; {len(failures)} failures: {failures}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
