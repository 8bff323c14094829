"""Compound sections on their own ranks: the port's section meshes on
spawned gloo ranks.

    python tests/torch_drivers/driver_sections.py CASE WORLD IN.npz OUT

``CASE`` is one of ``messages``, ``distill``, ``mllm``, ``compressed``,
``multi_teacher``, the context-parallel ``mllm_cp`` and ``distill_cp``,
and ``distill_tp`` (a teacher at tp 2) (the functions ``case_<name>`` below say what each
runs); ``IN.npz`` holds the batches (``batch<i>/<key>``) and, where a case
starts from given parameters, ``params/<section>/<path>``.  Every rank
that has something to report writes ``OUT.<rank>.npz``.  Prints
``DRIVER_OK sections <CASE>``.  Imports no ``jax`` and nothing of
``repro``, so the tests that compare with the JAX package run this in a
fresh process.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dist_util import flat, nest, spawn  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import workload as wl  # noqa: E402
from repro_torch.core.messages import MessageQueue, PeerTransport  # noqa
from repro_torch.core.messages import PullTimeout  # noqa: E402
from repro_torch.core.types import ParallelConfig  # noqa: E402
from repro_torch.distill import multi_teacher as mt  # noqa: E402
from repro_torch.distill.workload import DistillRuntime  # noqa: E402
from repro_torch.mllm import workload as mw  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.vlm import vit_config  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


# --------------------------------------------------------------------------- #
# configurations, shared with the tests
# --------------------------------------------------------------------------- #
def distill_cfgs():
    """tests/drivers/driver_distill_runtime.py's reduced qwen pairing."""
    return (get_reduced("qwen2.5-32b").replace(dtype="float32",
                                               vocab_size=512),
            get_reduced("qwen1.5-0.5b").replace(dtype="float32",
                                                vocab_size=512))


def mllm_cfgs():
    """tests/drivers/driver_mllm_runtime.py's reduced pairing (as
    tests/test_torch_mllm.py builds it)."""
    lm = get_reduced("pixtral-12b").replace(
        dtype="float32", vocab_size=256, vision_dim=32, max_image_tokens=4)
    vit = vit_config(num_layers=2, d_model=32, num_heads=2, d_ff=64,
                     patch_dim=16, downsample=4, out_dim=32,
                     name="vit-tiny").replace(dtype="float32")
    return vit, lm


MLLM_SHAPE = dict(global_batch=16, seq_len=32, mbs=4)
MLLM_OPT = adamw.AdamWConfig(clip_norm=0.05)


def mt_cfgs():
    """tests/drivers/driver_multi_teacher.py's three reduced models."""
    ta = get_reduced("qwen2.5-32b").replace(dtype="float32", vocab_size=256)
    tb = get_reduced("granite-3-8b").replace(dtype="float32", vocab_size=256,
                                             d_model=64, head_dim=16,
                                             d_ff=128)
    s = get_reduced("qwen1.5-0.5b").replace(dtype="float32", vocab_size=256)
    return ta, tb, s


MT_SHAPE = dict(global_batch=16, seq_len=32, mbs=4)

# tests/drivers/driver_compression.py:177-219
CB, CS, CMBS, CD = 8, 8, 4, 16


def compressed_spec(method: str, dp: int = 4) -> wl.WorkloadSpec:
    cfg = get_reduced("qwen1.5-0.5b")
    h_port = wl.Port("h", (CS, CD), "float32")
    par = ParallelConfig(dp=dp, grad_compress=method)

    def enc_fn(p, x):
        return {"h": torch.tanh(x["x"] @ p["w"])}

    def head_fn(p, x):
        pred = x["enc.h"] @ p["v"]
        return torch.mean(torch.square(pred - x["y"]))

    enc = wl.SectionSpec(
        "enc", cfg, par, enc_fn,
        {"w": cm.ParamSpec((CD, CD), (None, None), "normal",
                           torch.float32)},
        inputs={"x": wl.Field((CS, CD), "float32")}, emits=(h_port,))
    head = wl.SectionSpec(
        "head", cfg, par, head_fn,
        {"v": cm.ParamSpec((CD, CD), (None, None), "normal",
                           torch.float32)},
        inputs={"y": wl.Field((CS, CD), "float32")},
        consumes=(wl.Consume("enc", h_port),), loss=True, critical=True)
    return wl.WorkloadSpec("t", (enc, head), seq_len=CS, global_batch=CB,
                           mbs=CMBS)


def batches(arrays):
    """The batches of IN.npz, as tensors; a key ``bf16:<name>`` marks a
    bfloat16 field stored as float32 (exactly)."""
    out, i = [], 0
    while any(k.startswith(f"batch{i}/") for k in arrays.files):
        b = {}
        for k, v in nest(arrays, f"batch{i}/").items():
            if k.startswith("bf16:"):
                b[k[5:]] = torch.from_numpy(v).to(torch.bfloat16)
            else:
                b[k] = torch.from_numpy(np.asarray(v))
        out.append(b)
        i += 1
    return out


def to_npz(batch: dict, i: int) -> dict:
    """One batch of tensors -> IN.npz entries (see :func:`batches`)."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.dtype == torch.bfloat16:
            out[f"batch{i}/bf16:{k}"] = v.float().numpy()
        else:
            out[f"batch{i}/{k}"] = v.numpy()
    return out


def total(x: float) -> float:
    """``x`` summed over the world."""
    t = torch.tensor([float(x)], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t[0])


def scalars(m: dict, keys) -> list:
    return [float(m[k]) for k in keys]


# --------------------------------------------------------------------------- #
# cases
# --------------------------------------------------------------------------- #
def case_messages(rank, world, arrays, out):
    """tests/drivers/driver_messages.py's cases between ranks: a producer
    of dp 2 on ranks 0-1, a consumer of dp 4 on ranks 2-5."""
    assert world == 6
    q = MessageQueue(transport=PeerTransport("cpu"))
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    # 1-to-1: rank 0 -> rank 2, the whole tensor
    if rank == 0:
        q.send("vit", "llm", "h0", x, rank=2)
        q.count_push(x)
    if rank == 2:
        q.expect("vit", "llm", "h0", 0, (8, 4), torch.float32)
        got = q.recv("vit", "llm", "h0", [0])[0]
        assert torch.equal(got, x)
    # 2-to-4: producer rank q holds rows [4q, 4q+4) and sends them to each
    # consumer rank whose rows [2r, 2r+2) they overlap
    if rank < 2:
        for r in (2 * rank, 2 * rank + 1):
            q.send("teacher", "student", "h1", x[4 * rank:4 * rank + 4],
                   rank=2 + r)
        if rank == 0:      # the producer's origin counts the key once
            q.count_push(x)
    if rank >= 2:
        r = rank - 2
        src = r // 2
        q.expect("teacher", "student", "h1", src, (4, 4), torch.float32)
        frag = q.recv("teacher", "student", "h1", [src])[src]
        mine = frag.narrow(0, 2 * r - 4 * src, 2)
        assert torch.equal(mine, x[2 * r:2 * r + 2]), (rank, mine)
    # keys pulled in another order than pushed, on one pair of ranks
    if rank == 1:
        for k, v in (("k1", torch.ones(3)), ("k2", torch.zeros(3))):
            q.send("a", "b", k, v, rank=5)
            q.count_push(v)
    if rank == 5:
        for k in ("k1", "k2"):
            q.expect("a", "b", k, 1, (3,), torch.float32)
        assert torch.equal(q.recv("a", "b", "k2", [1])[1], torch.zeros(3))
        assert torch.equal(q.recv("a", "b", "k1", [1])[1], torch.ones(3))
    dist.barrier()
    # a message that never comes: PullTimeout names the producer
    if rank == 3:
        q.expect("late", "b", "k3", 0, (2,), torch.float32)
        try:
            q.recv("late", "b", "k3", [0], timeout=0.5)
            raise AssertionError("expected PullTimeout")
        except PullTimeout as e:
            assert "late" in str(e), e
    dist.barrier()
    if rank == 0:   # completes the receive the timed-out pull left posted
        q.send("late", "b", "k3", torch.zeros(2), rank=3)
    q.close()
    st = q.stats()
    out["pushes"] = np.array([total(st["pushes"])])
    out["fragments"] = np.array([total(st["fragments"])])


def case_distill(rank, world, arrays, out):
    """The teacher at dp 2 on ranks 0-1, the student at dp 4 on 2-5, four
    iterations of tests/drivers/driver_distill_runtime.py."""
    t_cfg, s_cfg = distill_cfgs()
    rt = DistillRuntime(t_cfg, s_cfg,
                        teacher_parallel=ParallelConfig(dp=2),
                        student_parallel=ParallelConfig(dp=4),
                        ranks=range(world), lr=1e-3)
    pt, ps, opt = rt.init(0)
    rt.runtime.install({n: p for n, p in (("teacher", pt), ("student", ps))
                        if p is not None},
                       {} if opt is None else {"student": opt})
    init, _ = rt.runtime.state()
    w_t = rt.teacher_unembed(pt)
    mets = []
    for i, b in enumerate(batches(arrays)):
        ps, opt, m = rt.train_iteration(pt, ps, opt, b, i, w_t=w_t)
        if "loss" in m:
            mets.append(scalars(m, ("loss", "ce", "kl", "grad_norm")))
    final, _ = rt.runtime.state()
    st = rt.rt.queue.stats()
    out["fanout"] = np.array([rt.fanout])
    out["pushes"] = np.array([total(st["pushes"])])
    out["fragments"] = np.array([total(st["fragments"])])
    if rank == 0:
        out.update(flat(init["teacher"], "init/teacher/"))
    if rank == 2:
        out.update(flat(init["student"], "init/student/"))
        out.update(flat(final["student"], "final/student/"))
        out["metrics"] = np.array(mets)
    rt.shutdown()


def given_params(arrays, crt) -> dict:
    """The full trees ``params/<section>/`` of ``arrays`` (float32) for the
    sections of ``crt`` (a ``CompoundRuntime``) this rank runs, in their
    parameters' dtypes."""
    def cast(tree, specs):
        if isinstance(tree, dict):
            return {k: cast(v, specs[k]) for k, v in tree.items()}
        return tree.to(specs.dtype)
    return {n: cast(params_from_numpy(nest(arrays, f"params/{n}/"),
                                      device="cpu"),
                    crt.spec.section(n).params)
            for n in crt.local_sections}


def case_distill_tp(rank, world, arrays, out):
    """The reference's distillation layout (tests/drivers/
    driver_distill_runtime.py): the teacher at (dp 2, tp 2) on ranks 0-3,
    the student at dp 4 on 4-7, from the full trees ``params/<section>/``
    of IN.npz, four iterations."""
    t_cfg, s_cfg = distill_cfgs()
    rt = DistillRuntime(t_cfg, s_cfg,
                        teacher_parallel=ParallelConfig(dp=2, tp=2),
                        student_parallel=ParallelConfig(dp=4),
                        ranks=range(world), lr=1e-3)
    params, opts = rt.runtime.place(given_params(arrays, rt.runtime))
    pt, ps, opt = (params.get("teacher"), params.get("student"),
                   opts.get("student"))
    w_t = rt.teacher_unembed(pt)
    mets = []
    for i, b in enumerate(batches(arrays)):
        ps, opt, m = rt.train_iteration(pt, ps, opt, b, i, w_t=w_t)
        if "loss" in m:
            mets.append(scalars(m, ("loss", "ce", "kl", "grad_norm")))
    final, _ = rt.runtime.state()
    st = rt.rt.queue.stats()
    out["pushes"] = np.array([total(st["pushes"])])
    out["fragments"] = np.array([total(st["fragments"])])
    if rank == 4:
        out.update(flat(final["student"], "final/student/"))
        out["metrics"] = np.array(mets)
    rt.shutdown()


def case_mllm(rank, world, arrays, out):
    """The ViT at dp 4 on ranks 0-3, the LM at dp 4 on 4-7: three
    iterations serialized (clip on), then the same streamed with
    lookahead 2."""
    vit, lm = mllm_cfgs()
    data = batches(arrays)
    par = ParallelConfig(dp=4)
    res = {}
    for depth in (0, 2):
        rt = mw.MLLMRuntime(vit, lm, vit_parallel=par, lm_parallel=par,
                            ranks=range(world), opt_cfg=MLLM_OPT,
                            lookahead=depth, **MLLM_SHAPE)
        params, opts = rt.init(3)
        plans = [rt.plan_iteration(b["has_image"].numpy()) for b in data]
        if depth == 0:
            rt.install(params, opts)
            init, _ = rt._crt.state()
            mets = []
            for i, (b, pl) in enumerate(zip(data, plans)):
                before = rt.rt.queue.stats()["pushes"]
                params, opts, m = rt.train_iteration(
                    params, opts, b, i, plan=pl, return_grads=True)
                pushes = total(rt.rt.queue.stats()["pushes"] - before)
                mets.append(m)
                out[f"it{i}/pushes"] = np.array([pushes])
                out[f"it{i}/order"] = np.array(pl.order)
                out[f"it{i}/fifo_image_mbs"] = np.array(
                    rt.plan_iteration(b["has_image"].numpy(),
                                      reorder=False).image_mbs)
                out[f"it{i}/image_mbs"] = np.array(pl.image_mbs)
                if m["n_vit_tasks"] is not None:
                    out[f"it{i}/n_vit_tasks"] = np.array([m["n_vit_tasks"]])
                out[f"it{i}/grad_norm"] = np.array([float(m["grad_norm"])])
                if "loss" in m:
                    out[f"it{i}/loss"] = np.array([float(m["loss"])])
                for n, g in m["grads"].items():
                    out.update(flat(g, f"it{i}/grads/{n}/"))
            for n, tree in init.items():
                out.update(flat(tree, f"init/{n}/"))
        else:
            rt.install(params, opts)
            for i, (b, pl) in enumerate(zip(data, plans)):
                rt.submit_iteration(b, i, plan=pl)
            mets = rt.drain()
        res[depth] = ([float(m["grad_norm"]) for m in mets],
                      [float(m["loss"]) for m in mets if "loss" in m],
                      rt._crt.state()[0])
        rt.shutdown()
    # streamed with lookahead 2 equals serialized bit for bit
    (g0, l0, p0), (g2, l2, p2) = res[0], res[2]
    assert g0 == g2 and l0 == l2, (g0, g2, l0, l2)
    for n in p0:
        for a, b in zip(cm.tree_leaves(p0[n]), cm.tree_leaves(p2[n])):
            assert torch.equal(a, b), n
    for n, tree in p0.items():
        out.update(flat(tree, f"final/{n}/"))


def case_mllm_cp(rank, world, arrays, out):
    """The ViT at (dp 2, cp 2) on ranks 0-3 (each holding half of every
    image's patches), the LM at dp 4 on 4-7: one iteration on the given
    plan, with its gradients (tests/drivers/driver_mllm_runtime.py's
    ViT-CP block).  Then the same with the LM at (dp 2, cp 2) as well,
    under ``lmcp/``: each LM sequence rank takes the image embeddings
    whole and splices the slots inside its shard."""
    vit, lm = mllm_cfgs()
    data = batches(arrays)
    for pre, lm_par in (("", ParallelConfig(dp=4)),
                        ("lmcp/", ParallelConfig(dp=2, cp=2))):
        rt = mw.MLLMRuntime(vit, lm, vit_parallel=ParallelConfig(dp=2, cp=2),
                            lm_parallel=lm_par, ranks=range(world),
                            opt_cfg=MLLM_OPT, **MLLM_SHAPE)
        params, opts = rt.init(3)
        for i, b in enumerate(data):
            plan = rt.plan_iteration(b["has_image"].numpy())
            params, opts, m = rt.train_iteration(
                params, opts, b, i, plan=plan, return_grads=True)
            it = f"{pre}it{i}"
            out[f"{it}/order"] = np.array(plan.order)
            out[f"{it}/image_mbs"] = np.array(plan.image_mbs)
            out[f"{it}/grad_norm"] = np.array([float(m["grad_norm"])])
            if m["n_vit_tasks"] is not None:
                out[f"{it}/n_vit_tasks"] = np.array([m["n_vit_tasks"]])
                out[f"{it}/vit_order"] = np.array(
                    m["execution"].dispatch_order["vit"])
            if "loss" in m:
                out[f"{it}/loss"] = np.array([float(m["loss"])])
            for n, g in m["grads"].items():
                out.update(flat(g, f"{it}/grads/{n}/"))
        final, _ = rt.state()
        for n, tree in final.items():
            out.update(flat(tree, f"{pre}final/{n}/"))
        rt.shutdown()


def case_distill_cp(rank, world, arrays, out):
    """The teacher at dp 2 on ranks 0-1, the student at (dp 2, cp 2) on
    2-5, from the given parameters (the same tree for both, as
    tests/drivers/driver_train_step_dist.py's colocated CP check): one
    iteration with that driver's optimizer.  Then the same with the
    teacher at tp 2 and the student at (cp 2, tp 2), under ``cptp/`` (the
    student's data degree must be a multiple of the teacher's): each of
    the student's model ranks runs ``cp_attention`` over its sequence
    group on its own head slice."""
    cfg = get_reduced("granite-3-8b").replace(dtype="float32", num_layers=4)
    for pre, teacher, student in (
            ("", ParallelConfig(dp=2), ParallelConfig(dp=2, cp=2)),
            ("cptp/", ParallelConfig(tp=2), ParallelConfig(cp=2, tp=2))):
        rt = DistillRuntime(cfg, cfg, teacher_parallel=teacher,
                            student_parallel=student,
                            ranks=range(world), lr=1e-3,
                            opt_cfg=adamw.AdamWConfig(eps=1e-3))
        full = _as_specs(params_from_numpy(nest(arrays, "params/"),
                                           device="cpu"),
                         rt.spec.section("student").params)
        placed, opts = rt.runtime.place({"teacher": full, "student": full})
        pt, ps = placed.get("teacher"), placed.get("student")
        opt = opts.get("student")
        w_t = rt.teacher_unembed(pt)
        for i, b in enumerate(batches(arrays)):
            ps, opt, m = rt.train_iteration(pt, ps, opt, b, i, w_t=w_t)
            if "loss" in m:
                out[f"{pre}it{i}/metrics"] = np.array(
                    scalars(m, ("loss", "ce", "kl", "grad_norm")))
        final, _ = rt.runtime.state()
        if "student" in final:
            out.update(flat(final["student"], f"{pre}final/student/"))
        rt.shutdown()


def case_compressed(rank, world, arrays, out):
    """enc at dp 4 on ranks 0-3, head at dp 4 on 4-7, from the given
    parameters: four iterations each with grad_compress "none", "bf16" and
    "int8"."""
    data = batches(arrays)
    for method in ("none", "bf16", "int8"):
        rt = wl.CompoundRuntime(compressed_spec(method), ranks=range(world),
                                opt_cfg=adamw.AdamWConfig(clip_norm=1.0))
        params = {n: params_from_numpy(nest(arrays, f"params/{n}/"),
                                       device="cpu")
                  for n in rt.local_sections}
        params, opts = rt.place(params)
        losses = []
        for i, b in enumerate(data):
            params, opts, m = rt.train_iteration(params, opts, b, i)
            if "loss" in m:
                losses.append(float(m["loss"]))
        if method == "int8":
            peak = max((float(x.abs().max()) for t in rt._ef.values()
                        for x in cm.tree_leaves(t)), default=0.0)
            p = torch.tensor([peak], dtype=torch.float64)
            dist.all_reduce(p, op=dist.ReduceOp.MAX)
            out["ef_max"] = p.numpy()
        if losses:
            out[f"{method}/loss"] = np.array(losses)
        rt.shutdown()


MT_METRICS = ("loss", "ce", "kl_a", "kl_b", "grad_norm")


def _given_plan(arrays, i: int, shape: dict):
    """Iteration ``i``'s ``IterationPlan`` from IN.npz (``plan<i>/order``,
    ``/active``, ``/idx``, ``/valid`` of the specialist), or None."""
    if f"plan{i}/order" not in arrays.files:
        return None
    act = wl.SectionActivation(
        tuple(int(x) for x in arrays[f"plan{i}/active"]),
        arrays[f"plan{i}/idx"], arrays[f"plan{i}/valid"])
    mbs = shape["mbs"]
    return wl.IterationPlan(tuple(int(x) for x in arrays[f"plan{i}/order"]),
                            mbs, shape["global_batch"] // mbs,
                            {"teacher_b": act})


def _as_specs(tree, specs):
    """``tree``'s leaves cast to the dtypes of their ``ParamSpec``s."""
    sp = cm.tree_leaves(cm.tree_like(tree, specs))
    return cm.tree_unflatten(tree, [x.to(s.dtype) for x, s in
                                    zip(cm.tree_leaves(tree), sp)])


def case_multi_teacher(rank, world, arrays, out):
    """The generalist on rank 0, the specialist on 1, the student on the
    other ``world - 2`` ranks (its data degree); the batches of IN.npz,
    from its parameters and plans where it holds them.  Each iteration
    records, per microbatch, how many of the specialist's samples fall in
    each student rank's rows."""
    ta, tb, s = mt_cfgs()
    s_dp = world - 2
    spec = mt.multi_teacher_spec(
        ta, tb, s, ta_parallel=ParallelConfig(), tb_parallel=ParallelConfig(),
        s_parallel=ParallelConfig(dp=s_dp), **MT_SHAPE)
    rt = wl.CompoundRuntime(spec, ranks=range(world),
                            opt_cfg=adamw.AdamWConfig(clip_norm=0.0))
    if any(k.startswith("params/") for k in arrays.files):
        # IN.npz holds float32 leaves: each goes back to its spec's dtype
        params, opts = rt.place({
            n: _as_specs(params_from_numpy(nest(arrays, f"params/{n}/"),
                                           device="cpu"),
                         spec.section(n).params)
            for n in rt.local_sections})
    else:
        params, opts = rt.init(0)
    consts = mt.student_consts(rt, params, ta, tb)
    for i, b in enumerate(batches(arrays)):
        plan = _given_plan(arrays, i, MT_SHAPE) or rt.plan_iteration(b)
        params, opts, m = rt.train_iteration(params, opts, b, i, plan=plan,
                                             consts=consts)
        out[f"it{i}/order"] = np.array(plan.order)
        out[f"it{i}/active"] = np.array(
            plan.activation["teacher_b"].active_mbs)
        dom = b["domain"].numpy().astype(bool)[np.asarray(plan.order)]
        out[f"it{i}/domain_rows"] = dom.reshape(
            plan.n_mb, s_dp, plan.mbs // s_dp).sum(-1)
        if "teacher_b" in rt.local_sections:
            out[f"it{i}/teacher_b_tasks"] = np.array(
                m["execution"].dispatch_order.get("teacher_b", []), dtype=str)
        if "loss" in m:
            out[f"it{i}/loss"] = np.array([float(m["loss"])])
            out[f"it{i}/metrics"] = np.array(scalars(m, MT_METRICS))
    final, _ = rt.state()
    if "student" in final:
        out.update(flat(final["student"], "final/student/"))
    rt.shutdown()


def work(rank, world, case, in_path, out_prefix):
    torch.use_deterministic_algorithms(True)
    arrays = np.load(in_path)
    out = {}
    globals()[f"case_{case}"](rank, world, arrays, out)
    if out:
        np.savez(f"{out_prefix}.{rank}.npz", **out)


if __name__ == "__main__":
    case, world = sys.argv[1], int(sys.argv[2])
    spawn(work, world, case, *sys.argv[3:5])
    print(f"DRIVER_OK sections {case}")
