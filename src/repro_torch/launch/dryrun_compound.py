"""Compound-workload dry-run: one compound training cell on a fake world,
the port's counterpart of ``repro/launch/dryrun_compound.py``, which
lowers and compiles the cell for 512 virtual devices.

Registered workloads (``--workload``, one runner each in
:data:`WORKLOADS`):

* ``distill`` (default): the colocated distillation step
  (``distill.workload.build_colocated_step``: the frozen teacher's forward
  and the student's training step with the hidden-state handoff, §3.1);
* ``mllm``: the colocated MLLM step (``mllm.workload
  .build_colocated_step``: per microbatch the ViT on its image rows and
  the LM loss with the image slots filled);
* ``multi_teacher``: the colocated multi-teacher step
  (``distill.multi_teacher.build_colocated_step``: two frozen teachers,
  the specialist on its routed rows, and the student's two KL terms).

As ``launch.dryrun`` does for one model, a cell runs in one process
standing for rank 0 of a world of ``REPRO_DRYRUN_DEVICES`` ranks (default:
the mesh's size) on PyTorch's fake process group, on the production mesh
(data 16 x model 16, ``--cp`` carving a ``seq`` axis out of ``data``) or
``REPRO_DRYRUN_MESH``'s; it builds the step with ``mesh=``, this rank's
blocks of every argument as fake tensors on the ``meta`` device (of the
batch, the block ``step.block`` cuts, as the step takes it), and records
one call
(``roofline.record``).  The hand-written kernels' ops,
``repro_torch::flash_fwd``, ``::flash_bwd``, ``::distill_kl_fwd`` and
``::distill_kl_bwd``, give their shape functions' outputs there.

The record has the reference's keys: ``workload``, ``mesh``, ``memory``
(XLA's four fields, the port's ``peak_bytes`` and ``argument_parts``),
``hlo``, ``roofline`` (on ``core.types.H100``), ``model_flops`` (the
reference's formulas) and ``useful_flops_ratio``, with ``n_microbatches``,
``mbs``, ``image_tokens`` and ``vit_patches`` where the reference has
them; ``record_s`` in place of ``compile_s``; and the port's ``devices``,
``kernel_adjusted_memory_s``, ``hlo["kernel_ops"]`` (each kernel op's
recorded calls) and ``hlo["kernel_flops"]`` (their FLOPs, by the ops'
flop formulas).  File names are the reference's.

Usage:
  python -m repro_torch.launch.dryrun_compound \\
      [--workload distill --teacher granite-3-8b --student granite-3-8b]
  python -m repro_torch.launch.dryrun_compound --workload mllm \\
      [--arch pixtral-12b]
  python -m repro_torch.launch.dryrun_compound --workload multi_teacher \\
      [--teacher2 granite-3-8b]
  REPRO_DRYRUN_TINY=1 REPRO_DRYRUN_DEVICES=8 REPRO_DRYRUN_MESH=4,2 ...
      # reduced configs, seq <= 128, batch <= 8 (a 2-layer ViT of width 64)

``--layers`` and ``--vit-layers`` (the port's own) cut the models' depth,
as the cells measured on one card are cut; a record names its models'
depths under ``num_layers``.

``--cp`` where the mesh also has a ``model`` axis above 1 records the
step at cp x tp.
"""
import argparse
import collections
import json
import os
import time
from pathlib import Path

from repro_torch.launch.dryrun import (DEVICE, _analytic_kernel_io, _nbytes,
                                       fake_blocks, fake_world)


def _mesh(cp: int):
    """(mesh, its {axis: size}, device count): ``REPRO_DRYRUN_MESH``'s or
    the production mesh, with a ``seq`` axis of ``cp`` carved out of the
    data axis, on a fake world of ``REPRO_DRYRUN_DEVICES`` ranks."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import env_dims, make_mesh, production_dims
    got = env_dims()
    dims, names = got or production_dims(cp=cp)
    sizes = dict(zip(names, dims))
    if got is not None and cp > 1 and sizes.get("seq", 1) != cp:
        if "seq" in sizes or sizes["data"] % cp:
            raise ValueError(f"--cp {cp} does not fit REPRO_DRYRUN_MESH "
                             f"{sizes}")
        sizes = {**({"pod": sizes["pod"]} if "pod" in sizes else {}),
                 "data": sizes["data"] // cp, "pipe": 1, "seq": cp,
                 "model": sizes["model"]}
        dims, names = tuple(sizes.values()), tuple(sizes)
    n_dev = 1
    for d in dims:
        n_dev *= d
    fake_world(int(os.environ.get("REPRO_DRYRUN_DEVICES", n_dev)), 0)
    mesh = make_mesh(dims, names)
    return mesh, shd.mesh_shape(mesh), n_dev


def _meta(shape, dtype):
    import torch
    return torch.empty(shape, dtype=dtype, device=DEVICE)


def _analyze(step, args, parts: dict, rec: dict, model_flops: float,
             n_devices: int, kernel_io: float) -> dict:
    """Record one call of ``step(*args)`` into ``rec`` (call under
    ``FakeTensorMode``)."""
    from repro_torch.core.types import H100
    from repro_torch.roofline.analysis import (collective_families,
                                               roofline_terms,
                                               wire_bytes_by_dtype)
    from repro_torch.roofline.record import record
    t0 = time.time()
    out, stats = record(step, *args)
    del out
    rec["record_s"] = time.time() - t0
    stats.memory["argument_parts"] = {k: _nbytes(v) for k, v in parts.items()}
    kernels = [d for d in stats.dots if d.op.startswith("repro_torch.")]
    kernel_flops = collections.Counter()
    for d in kernels:
        kernel_flops[d.op] += d.flops
    rec["memory"] = stats.memory
    rec["hlo"] = {
        "flops_per_device": stats.flops,
        "hbm_bytes_per_device": stats.hbm_bytes,
        "kernel_bytes_per_device": stats.kernel_bytes,
        "collective_bytes_per_device": collective_families(stats),
        "wire_bytes_by_dtype": wire_bytes_by_dtype(stats),
        "transcendental_per_device": stats.transcendental,
        "ops": stats.ops,
        "kernel_ops": dict(collections.Counter(d.op for d in kernels)),
        "kernel_flops": dict(kernel_flops)}
    rec["roofline"] = roofline_terms(stats, hw=H100)
    rec["kernel_adjusted_memory_s"] = (
        max(stats.hbm_bytes - stats.kernel_bytes, 0.0) + kernel_io
    ) / H100.hbm_bandwidth
    rec["model_flops"] = model_flops
    rec["useful_flops_ratio"] = model_flops / max(stats.flops * n_devices, 1)
    rec["devices"] = n_devices
    return rec


def _emit(rec: dict, out_dir: str, name: str) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / name).write_text(json.dumps(rec, indent=2))
    print(json.dumps(rec["roofline"]))
    print("useful:", rec["useful_flops_ratio"])
    print("wrote", out / name)


def _tiny() -> bool:
    return bool(os.environ.get("REPRO_DRYRUN_TINY"))


def _lm_batch(shape, lead=()) -> dict:
    """Meta tokens and labels (int64) and loss mask (float32) of
    ``lead + shape``."""
    import torch
    s = tuple(lead) + tuple(shape)
    return {"tokens": _meta(s, torch.int64), "labels": _meta(s, torch.int64),
            "loss_mask": _meta(s, torch.float32)}


def _depth(cfg, args):
    """``cfg`` with its depth cut to ``--layers`` when given."""
    return cfg.replace(num_layers=args.layers) if args.layers else cfg


def _kl_io(calls: int, tokens: int, s_cfg, t_cfg) -> tuple:
    """One distillation-KL term for :func:`_analytic_kernel_io`: ``calls``
    calls on ``tokens`` rows each (a model rank's share of a micro-batch's
    rows on this device)."""
    return (calls, tokens, s_cfg.d_model, t_cfg.d_model, s_cfg.padded_vocab)


def _run_distill(args) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.types import ShapeConfig
    from repro_torch.distill import workload as dw
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train.step import mesh_parallel

    t_cfg, s_cfg = get_config(args.teacher), get_config(args.student)
    seq, batch = args.seq, args.batch
    if _tiny():
        t_cfg, s_cfg = reduce_config(t_cfg), reduce_config(s_cfg)
        seq, batch = min(seq, 128), min(batch, 8)
    t_cfg, s_cfg = _depth(t_cfg, args), _depth(s_cfg, args)
    mesh, sizes, n_dev = _mesh(args.cp)
    par = mesh_parallel(mesh, args.mbs or 1)
    shape = ShapeConfig("distill", "train", seq, batch)
    rec = {"workload": f"distill:{args.teacher}->{args.student}",
           "mesh": "single",
           "num_layers": {"teacher": t_cfg.num_layers,
                          "student": s_cfg.num_layers}}
    toks = batch * seq
    model_flops = (6 * s_cfg.active_params()
                   + 2 * t_cfg.active_params()) * toks
    # allow_non_fake_inputs: the DeviceMesh's own rank tensor is real
    with FakeTensorMode(allow_non_fake_inputs=True):
        step = dw.build_colocated_step(t_cfg, s_cfg, shape, par, mesh=mesh)
        s_specs, t_specs = tf.lm_specs(s_cfg), tf.lm_specs(t_cfg)
        parts = {"student": fake_blocks(s_specs, step.shardings["student"],
                                        sizes),
                 "opt": fake_blocks(adamw.state_specs(s_specs),
                                    step.shardings["opt"], sizes),
                 "teacher": fake_blocks(t_specs, step.shardings["teacher"],
                                        sizes),
                 "batch": step.block(_lm_batch((batch, seq)))}
        n_micro = max(batch // (par.dp * par.mbs), 1)
        per_call = parts["batch"]["tokens"].numel() // n_micro // par.tp
        kio = (_analytic_kernel_io(s_cfg, shape, n_dev,
                                   kl=[_kl_io(n_micro, per_call, s_cfg,
                                              t_cfg)])
               + _analytic_kernel_io(t_cfg, ShapeConfig(
                   "t", "prefill", seq, batch), n_dev))
        _analyze(step, (parts["student"], parts["opt"], parts["teacher"],
                        parts["batch"], 0), parts, rec, model_flops, n_dev,
                 kio)
    _emit(rec, args.out,
          f"compound_distill__{args.teacher}__{args.student}__single.json")
    return rec


def _run_mllm(args) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.types import ShapeConfig
    from repro_torch.mllm import workload as mw
    from repro_torch.models import transformer as tf
    from repro_torch.models.vlm import (downsample_factor, vit_config,
                                        vit_specs)
    from repro_torch.optim import adamw

    lm_cfg = get_config(args.arch)
    if not lm_cfg.vision_dim:
        raise ValueError(f"{args.arch} is not a VLM arch")
    seq, batch = args.seq, args.batch
    if _tiny():
        lm_cfg = reduce_config(lm_cfg).replace(vision_dim=64,
                                               max_image_tokens=8)
        seq, batch = min(seq, 128), min(batch, 8)
        vit_cfg = vit_config(num_layers=2, d_model=64, num_heads=4,
                             d_ff=128, patch_dim=32, downsample=4,
                             out_dim=lm_cfg.vision_dim)
    else:
        # the paper's 0.4B-class ViT encoder feeding the backbone
        vit_cfg = vit_config(out_dim=lm_cfg.vision_dim)
    lm_cfg = _depth(lm_cfg, args)
    if args.vit_layers:
        vit_cfg = vit_cfg.replace(num_layers=args.vit_layers)
    mbs = args.mbs if args.mbs is not None else min(8, batch)
    if batch % mbs:
        raise ValueError(
            f"--batch {batch} is not a multiple of mbs={mbs}: the "
            "microbatched step would lower for a different sample count "
            "than the reported model_flops")
    n_mb = batch // mbs
    K = lm_cfg.max_image_tokens or min(seq // 4, 2048)
    lm_cfg = lm_cfg.replace(max_image_tokens=K)
    P = K * downsample_factor(vit_cfg)
    mesh, sizes, n_dev = _mesh(1)
    rec = {"workload": f"mllm:{vit_cfg.name}->{args.arch}",
           "mesh": "single", "n_microbatches": n_mb, "mbs": mbs,
           "image_tokens": K, "vit_patches": P,
           "num_layers": {"vit": vit_cfg.num_layers,
                          "lm": lm_cfg.num_layers}}
    toks, vit_toks = batch * seq, batch * P
    model_flops = (6 * lm_cfg.active_params() * toks
                   + 6 * vit_cfg.total_params() * vit_toks)
    dt = torch.bfloat16 if lm_cfg.dtype == "bfloat16" else torch.float32
    with FakeTensorMode(allow_non_fake_inputs=True):
        step = mw.build_colocated_step(vit_cfg, lm_cfg, device=DEVICE,
                                       mesh=mesh)
        specs = {"vit": vit_specs(vit_cfg), "lm": tf.lm_specs(lm_cfg)}
        b = _lm_batch((mbs, seq), (n_mb,))
        b.update(image_pos=_meta((n_mb, mbs, K), torch.int64),
                 image_valid=_meta((n_mb, mbs, K), torch.int32),
                 patches=_meta((n_mb, mbs, P, vit_cfg.frontend_dim), dt),
                 vis_idx=_meta((n_mb, mbs), torch.int64),
                 vis_valid=_meta((n_mb, mbs), torch.float32))
        b = step.block(b)
        parts = {"params": fake_blocks(specs, step.shardings["params"],
                                       sizes),
                 "opt": fake_blocks(adamw.state_specs(specs),
                                    step.shardings["opt"], sizes),
                 "batch": b}
        kio = (_analytic_kernel_io(lm_cfg, ShapeConfig(
                   "lm", "train", seq, batch), n_dev)
               + _analytic_kernel_io(vit_cfg, ShapeConfig(
                   "vit", "train", P, batch), n_dev))
        _analyze(step, (parts["params"], parts["opt"], b, 0), parts, rec,
                 model_flops, n_dev, kio)
    _emit(rec, args.out,
          f"compound_mllm__{vit_cfg.name}__{args.arch}__single.json")
    return rec


def _run_multi_teacher(args) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.types import ShapeConfig
    from repro_torch.distill import multi_teacher as mt
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train.step import mesh_parallel

    ta_cfg, tb_cfg = get_config(args.teacher), get_config(args.teacher2)
    s_cfg = get_config(args.student)
    seq, batch = args.seq, args.batch
    if _tiny():
        ta_cfg, tb_cfg = reduce_config(ta_cfg), reduce_config(tb_cfg)
        s_cfg = reduce_config(s_cfg)
        seq, batch = min(seq, 128), min(batch, 8)
    ta_cfg, tb_cfg, s_cfg = (_depth(c, args) for c in (ta_cfg, tb_cfg, s_cfg))
    mbs = args.mbs if args.mbs is not None else min(8, batch)
    if batch % mbs:
        raise ValueError(f"--batch {batch} is not a multiple of "
                         f"mbs={mbs}")
    n_mb = batch // mbs
    mesh, sizes, n_dev = _mesh(1)
    rec = {"workload": (f"multi_teacher:{args.teacher}+{args.teacher2}"
                        f"->{args.student}"),
           "mesh": "single", "n_microbatches": n_mb, "mbs": mbs,
           "num_layers": {"teacher_a": ta_cfg.num_layers,
                          "teacher_b": tb_cfg.num_layers,
                          "student": s_cfg.num_layers}}
    toks = batch * seq
    model_flops = (6 * s_cfg.active_params() + 2 * ta_cfg.active_params()
                   + 2 * tb_cfg.active_params()) * toks

    def dtype(cfg):
        return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    with FakeTensorMode(allow_non_fake_inputs=True):
        step = mt.build_colocated_step(ta_cfg, tb_cfg, s_cfg, mesh=mesh)
        specs = {k: tf.lm_specs(c) for k, c in (
            ("student", s_cfg), ("teacher_a", ta_cfg), ("teacher_b", tb_cfg))}
        parts = {k: fake_blocks(v, step.shardings[k], sizes)
                 for k, v in specs.items()}
        parts["opt"] = fake_blocks(adamw.state_specs(specs["student"]),
                                   step.shardings["opt"], sizes)
        parts["w"] = [_meta((c.d_model, c.padded_vocab), dtype(c))
                      for c in (ta_cfg, tb_cfg)]
        b = _lm_batch((mbs, seq), (n_mb,))
        b.update(b_idx=_meta((n_mb, mbs), torch.int64),
                 b_valid=_meta((n_mb, mbs), torch.float32))
        b = parts["batch"] = step.block(b)
        par = mesh_parallel(mesh)
        per_call = mbs // par.dp * seq // par.tp
        tr = ShapeConfig("t", "prefill", seq, batch)
        kio = (_analytic_kernel_io(
                   s_cfg, ShapeConfig("s", "train", seq, batch), n_dev,
                   kl=[_kl_io(n_mb, per_call, s_cfg, ta_cfg),
                       _kl_io(n_mb, per_call, s_cfg, tb_cfg)])
               + _analytic_kernel_io(ta_cfg, tr, n_dev)
               + _analytic_kernel_io(tb_cfg, tr, n_dev))
        _analyze(step, (parts["student"], parts["opt"], parts["teacher_a"],
                        parts["teacher_b"], *parts["w"], b, 0), parts, rec,
                 model_flops, n_dev, kio)
    _emit(rec, args.out,
          f"compound_multi_teacher__{args.teacher}__{args.teacher2}"
          f"__{args.student}__single.json")
    return rec


#: every registered compound workload
WORKLOADS = {
    "distill": _run_distill,
    "mllm": _run_mllm,
    "multi_teacher": _run_multi_teacher,
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="distill",
                    choices=tuple(WORKLOADS))
    ap.add_argument("--teacher", default="granite-3-8b")
    ap.add_argument("--student", default="granite-3-8b")
    ap.add_argument("--arch", default="pixtral-12b",
                    help="mllm backbone arch (must have a vision stub)")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mbs", type=int, default=None,
                    help="micro-batch size (default: 1 for distill, "
                         "min(8, batch) for mllm and multi_teacher)")
    ap.add_argument("--cp", type=int, default=1,
                    help="context parallelism: carve a seq axis out of "
                         "the data axis (teacher and student attention run "
                         "through cp_attention; distill only)")
    ap.add_argument("--teacher2", default="granite-3-8b",
                    help="specialist teacher for --workload multi_teacher")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every language model's depth to this many "
                         "layers (a cell measured on one card at a cut "
                         "depth)")
    ap.add_argument("--vit-layers", type=int, default=None,
                    help="cut the mllm ViT's depth to this many layers")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    return WORKLOADS[args.workload](args)


if __name__ == "__main__":
    main()
