"""The port's context-parallel attention (``repro_torch.dist.context``)
against the JAX package, on the CPU.

(a) ``merge_flash_partials`` on the reference's three merge cases
    (``tests/test_kernels_flash.py``): contiguous chunks, strided chunk
    positions forward and backward, a fully masked chunk; each against
    the port's monolithic plain flash and the JAX merge on the same
    inputs, within 2e-5 (1e-4 for the strided case's gradients, the
    reference's).
(b) ``resolve_cp_mode`` and ``roofline.analysis.cp_attention_comm``
    against the reference's, over a grid of head counts and CP degrees,
    exactly; the impl's errors name the section.
(c) The CP attention matrix of ``tests/drivers/driver_pipeline_cp.py``
    (B 2, S 64, H 8, KV 4, D 16, causal) on 4 gloo ranks (ulysses,
    allgather, chunks 2 and 4, chunks 4 with window 24, auto) and on 8
    (ulysses_mqa, allgather, auto): the forward and dq/dk/dv of
    ``sum(o ** 2)`` against ``repro.kernels.ref.mha_reference`` and
    against the JAX ``cp_attention`` on Auto meshes of 4 and 8 virtual
    devices, within 2e-5 (the driver's).  The ranks run
    ``tests/torch_drivers/driver_context.py attn``; the JAX side runs in a
    subprocess while they do (``python tests/test_torch_context.py
    --jax-oracle IN.npz OUT.npz``).
(d) The refusals of context parallelism: audio and attention-free
    archs, pp x cp, segment ids, cross-attention, a sequence that does not divide cp, chunks that do
    not divide S/cp, ulysses with H % cp, an unknown mode, grad_compress
    under cp, and a ViT shard that is not a multiple of its merge; and
    what now passes the same checks into the cp regime: MoE and hybrid
    archs at cp x tp, the vlm family's image splice, an MLLM LM at cp 2.
"""
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.core import workload as twl  # noqa: E402
from repro_torch.core.types import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.dist import context as tcx  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.kernels.flash_attention import \
    merge_flash_partials  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.mllm import workload as tmw  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402
from repro_torch.models.vlm import vit_config  # noqa: E402
from repro_torch.roofline.analysis import cp_attention_comm  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ROOT / "tests" / "torch_drivers"
sys.path.insert(0, str(DRIVERS))
import driver_context  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
B, S, H, KV, D = 2, 64, 8, 4, 16


# --------------------------------------------------------------------------- #
# (a) merge_flash_partials
# --------------------------------------------------------------------------- #
def _qkv(shape, seed=0):
    Bq, Sq, T, Hq, KVq, Dq = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bq, Sq, Hq, Dq)).astype(np.float32),
            rng.standard_normal((Bq, T, KVq, Dq)).astype(np.float32),
            rng.standard_normal((Bq, T, KVq, Dq)).astype(np.float32))


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


def _jax_merge(o_parts, lse_parts):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import merge_flash_partials as jm
    o, lse = jm([jnp.asarray(x.detach().numpy()) for x in o_parts],
                [jnp.asarray(x.detach().numpy()) for x in lse_parts])
    return np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 24)])
@pytest.mark.parametrize("Hq,KVq", [(4, 4), (8, 2)])
@pytest.mark.parametrize("q_offset", [0, 64])
def test_merge_matches_monolithic_contiguous(causal, window, Hq, KVq,
                                             q_offset):
    q, k, v = _t(*_qkv((1, 64, 128, Hq, KVq, 16)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o_mono = flash_attention_ref(q, k, v, **kw)[0]
    cl = 128 // 4
    parts_o, parts_lse = [], []
    for j in range(4):
        pos = torch.arange(j * cl, (j + 1) * cl, dtype=torch.int32)
        oj, lj = flash_attention_ref(q, k[:, j * cl:(j + 1) * cl],
                                     v[:, j * cl:(j + 1) * cl],
                                     kv_positions=pos, **kw)
        parts_o.append(oj)
        parts_lse.append(lj)
    o, lse = merge_flash_partials(parts_o, parts_lse)
    np.testing.assert_allclose(o.numpy(), o_mono.numpy(), **TOL)
    jo, jlse = _jax_merge(parts_o, parts_lse)
    np.testing.assert_allclose(o.numpy(), jo, **TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, **TOL)


def test_merge_matches_monolithic_strided():
    T, cp, chunks = 128, 4, 2
    shard, cl = T // cp, T // cp // chunks
    q, k, v = _t(*_qkv((1, T, T, 4, 2, 16)), grad=True)

    def chunked(q, k, v):
        parts_o, parts_lse = [], []
        for j in range(chunks):
            sel = torch.as_tensor(
                (np.arange(cp)[:, None] * shard + j * cl
                 + np.arange(cl)[None, :]).reshape(-1), dtype=torch.int32)
            oj, lj = flash_attention_ref(q, k.index_select(1, sel.long()),
                                         v.index_select(1, sel.long()),
                                         causal=True, kv_positions=sel)
            parts_o.append(oj)
            parts_lse.append(lj)
        return merge_flash_partials(parts_o, parts_lse)[0]

    def mono(q, k, v):
        return flash_attention_ref(q, k, v, causal=True)[0]

    np.testing.assert_allclose(chunked(q, k, v).detach().numpy(),
                               mono(q, k, v).detach().numpy(), **TOL)
    g1 = torch.autograd.grad(torch.sin(chunked(q, k, v)).sum(), [q, k, v])
    g2 = torch.autograd.grad(torch.sin(mono(q, k, v)).sum(), [q, k, v])
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_merge_all_masked_chunk_is_inert():
    q, k, v = _t(*_qkv((1, 32, 64, 2, 2, 8)))
    k_past, v_past = k[:, :32], v[:, :32]
    k_fut = k[:, 32:].clone().requires_grad_()
    v_fut = v[:, 32:].clone().requires_grad_()
    pos_past = torch.arange(32, dtype=torch.int32)
    pos_fut = torch.arange(32, 64, dtype=torch.int32)   # all > max q pos
    o1, l1 = flash_attention_ref(q, k_past, v_past, causal=True,
                                 kv_positions=pos_past)
    o2, l2 = flash_attention_ref(q, k_fut, v_fut, causal=True,
                                 kv_positions=pos_fut)
    assert float(l2.detach().max()) <= -1e29
    o, _ = merge_flash_partials([o1, o2], [l1, l2])
    assert bool(torch.isfinite(o).all())
    o_ref = flash_attention_ref(q, k_past, v_past, causal=True)[0]
    np.testing.assert_allclose(o.detach().numpy(), o_ref.numpy(), **TOL)
    gk, gv = torch.autograd.grad((o ** 2).sum(), [k_fut, v_fut])
    assert torch.count_nonzero(gk) == 0 and torch.count_nonzero(gv) == 0


# --------------------------------------------------------------------------- #
# (b) mode resolution and the wire model
# --------------------------------------------------------------------------- #
GRID = [(h, kv, cp) for h in (1, 2, 4, 8, 12, 16, 32)
        for kv in (1, 2, 4, 8, 16) if h % kv == 0 for cp in (1, 2, 4, 8)]


def test_resolve_cp_mode_matches_reference():
    from repro.dist.context import resolve_cp_mode as jresolve
    for mode in tcx.CP_MODES:
        for h, kv, cp in GRID:
            try:
                want = jresolve(mode, H=h, KV=kv, cp=cp)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tcx.resolve_cp_mode(mode, H=h, KV=kv, cp=cp)
                assert str(got.value) == str(e)
                continue
            assert tcx.resolve_cp_mode(mode, H=h, KV=kv, cp=cp) == want
    # the reference's own three cases
    assert tcx.resolve_cp_mode("auto", H=8, KV=4, cp=4) == "ulysses"
    assert tcx.resolve_cp_mode("auto", H=8, KV=4, cp=8) == "ulysses_mqa"
    assert tcx.resolve_cp_mode("auto", H=8, KV=1, cp=8) == "allgather"


def test_cp_attention_comm_matches_reference():
    from repro.roofline.analysis import cp_attention_comm as jcomm
    n = 0
    for mode in ("ulysses", "ulysses_mqa", "allgather"):
        for h, kv, cp in GRID:
            for chunks in (1, 2, 4):
                kw = dict(H=h, KV=kv, D=16, cp=cp, B=2, S=64 * cp,
                          itemsize=2, overlap_chunks=chunks)
                try:
                    want = jcomm(mode, **kw)
                except ValueError:
                    with pytest.raises(ValueError):
                        cp_attention_comm(mode, **kw)
                    continue
                assert cp_attention_comm(mode, **kw) == want
                n += 1
    assert n > 100
    with pytest.raises(ValueError, match="unknown"):
        cp_attention_comm("ring", H=8, KV=4, D=16, cp=4)


def test_cp_attention_impl_errors_name_section():
    impl = tcx.cp_attention_impl(None, section="vit_tower")
    q = torch.zeros((1, 8, 4, 8))
    seg = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="vit_tower"):
        impl(q, q[:, :, :2], q[:, :, :2], segment_q=seg, segment_kv=seg)
    with pytest.raises(NotImplementedError, match="vit_tower"):
        impl(q, q[:, :4, :2], q[:, :4, :2])   # S_q != S_kv
    with pytest.raises(ValueError, match="vit_tower"):
        tcx.resolve_cp_mode("ulysses", H=8, KV=3, cp=4, section="vit_tower")
    with pytest.raises(ValueError, match="unknown mode 'ring'"):
        tcx.resolve_cp_mode("ring", H=8, KV=4, cp=4, section="vit_tower")


# --------------------------------------------------------------------------- #
# (c) the CP attention matrix on 4 and 8 gloo ranks
# --------------------------------------------------------------------------- #
def jax_oracle(in_path: str, out_path: str) -> None:
    """``mha_reference`` and the JAX ``cp_attention`` (Auto meshes of 4
    and 8 virtual devices, the ref kernel tier) for every case of
    driver_context.ATTN_CASES: o and the gradients of ``sum(o ** 2)``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh
    from repro.dist.context import cp_attention
    from repro.kernels import ref

    assert len(jax.devices()) == 8, jax.devices()
    a = np.load(in_path)
    q, k, v = (jnp.asarray(a[x]) for x in ("q", "k", "v"))
    out = {}

    def grads(fn):
        o = jax.jit(fn)(q, k, v)
        g = jax.jit(jax.grad(lambda *x: jnp.sum(fn(*x) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
        return [np.asarray(x) for x in (o, *g)]

    for window in (0, 24):
        got = grads(lambda q, k, v: ref.mha_reference(q, k, v, causal=True,
                                                      window=window))
        for key, x in zip(("o", "dq", "dk", "dv"), got):
            out[f"mha_w{window}/{key}"] = x
    for world, cases in driver_context.ATTN_CASES.items():
        mesh = Mesh(np.array(jax.devices()[:world]), ("model",),
                    axis_types=(AxisType.Auto,))
        for name, mode, chunks, window in cases:
            def f(q, k, v):
                return cp_attention(q, k, v, mesh, mode=mode, causal=True,
                                    window=window, overlap_chunks=chunks,
                                    block_q=16, block_kv=16, impl="ref")
            with mesh:
                got = grads(f)
            for key, x in zip(("o", "dq", "dk", "dv"), got):
                out[f"{world}/{name}/{key}"] = x
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def attn_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cp")
    rng = np.random.default_rng(1)
    arrays = {"q": rng.standard_normal((B, S, H, D)).astype(np.float32),
              "k": rng.standard_normal((B, S, KV, D)).astype(np.float32),
              "v": rng.standard_normal((B, S, KV, D)).astype(np.float32)}
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(DRIVERS)]))
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), str(DRIVERS)]))
    oracle = subprocess.Popen(
        [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
         str(tmp / "jax.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=jenv)
    got = {}
    for world in driver_context.ATTN_CASES:
        proc = subprocess.run(
            [sys.executable, str(DRIVERS / "driver_context.py"), "attn",
             str(world), str(tmp / "in.npz"), str(tmp / f"out{world}.npz")],
            capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 0 and "DRIVER_OK context attn" in \
            proc.stdout, proc.stdout[-3000:] + proc.stderr[-6000:]
        got[world] = np.load(tmp / f"out{world}.npz")
    out, err = oracle.communicate(timeout=600)
    assert oracle.returncode == 0, out[-3000:] + err[-6000:]
    return got, np.load(tmp / "jax.npz")


CASES = [(w, name, window) for w, cases in driver_context.ATTN_CASES.items()
         for name, _, _, window in cases]


@pytest.mark.parametrize("world,name,window", CASES,
                         ids=[f"{w}-{n}" for w, n, _ in CASES])
def test_cp_attention_matches_mha_reference_and_jax(attn_run, world, name,
                                                    window):
    got, jx = attn_run
    for key in ("o", "dq", "dk", "dv"):
        have = got[world][f"{name}/{key}"]
        np.testing.assert_allclose(have, jx[f"mha_w{window}/{key}"],
                                   err_msg=f"{name} {key} vs mha", **TOL)
        np.testing.assert_allclose(have, jx[f"{world}/{name}/{key}"],
                                   err_msg=f"{name} {key} vs JAX cp", **TOL)


# --------------------------------------------------------------------------- #
# (d) refusals
# --------------------------------------------------------------------------- #
def _mesh(**sizes):
    base = {"data": 1, "pipe": 1, "seq": 1, "model": 1}
    base.update(sizes)
    return base


def _build(arch, par, seq=8, mesh=None, **over):
    cfg = tcfgs.get_reduced(arch).replace(dtype="float32", **over)
    return tstep.build_train_step(
        tbuild(cfg, device="cpu"), par, ShapeConfig("t", "train", seq, 4),
        mesh=mesh or _mesh(seq=par.cp, data=par.dp, model=par.tp))


@pytest.mark.parametrize("arch,par,exc,match", [
    ("whisper-small", ParallelConfig(cp=2), NotImplementedError, "audio"),
    ("mamba2-130m", ParallelConfig(cp=2), NotImplementedError,
     "attention-free"),
    # MoE and hybrid run at cp > 1 (their router statistics are averaged
    # over the sequence ranks), cp x tp runs for every family and so does
    # the vlm family's image splice: the step's checks name their regime
    # (exc None; the steps themselves: tests/test_torch_context_step.py)
    ("mixtral-8x22b", ParallelConfig(cp=2, tp=2), None, "cp"),
    ("jamba-v0.1-52b", ParallelConfig(cp=2, tp=2), None, "cp"),
    ("pixtral-12b", ParallelConfig(cp=2), None, "cp"),
])
def test_cp_step_refuses_families(arch, par, exc, match):
    if exc is None:
        cfg = tcfgs.get_reduced(arch).replace(dtype="float32")
        regime, _, _ = tstep._check_sharded(
            cfg, par, ShapeConfig("t", "train", 8, 4),
            _mesh(seq=par.cp, data=par.dp, model=par.tp))
        assert regime == match
        return
    with pytest.raises(exc, match=match):
        _build(arch, par)


@pytest.mark.parametrize("par,seq,exc,match", [
    (ParallelConfig(cp=2), 9, ValueError, "does not divide"),
    (ParallelConfig(cp=2, cp_mode="ring"), 8, ValueError, "cp_mode"),
    (ParallelConfig(cp=2, cp_overlap_chunks=0), 8, ValueError, ">= 1"),
    (ParallelConfig(cp=2, cp_mode="allgather", cp_overlap_chunks=2), 8,
     ValueError, "only applies to the ulysses"),
    (ParallelConfig(dp=2, cp=2, grad_compress="bf16"), 8,
     NotImplementedError, "plain regime"),
])
def test_cp_step_refuses_knobs(par, seq, exc, match):
    with pytest.raises(exc, match=match):
        _build("qwen1.5-0.5b", par, seq=seq)


def test_cp_regime_and_attention_free_property():
    assert tstep.parallel_regime(_mesh(data=2, seq=2), ParallelConfig(
        dp=2, cp=2, cp_mode="ulysses", cp_overlap_chunks=2)) == "cp"
    assert tstep.parallel_regime(_mesh(data=2), ParallelConfig(dp=2)) == \
        "plain"
    assert tcfgs.get_reduced("mamba2-130m").attention_free
    assert not tcfgs.get_reduced("jamba-v0.1-52b").attention_free


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield shd.section_mesh([0], ParallelConfig())
    finally:
        dist.destroy_process_group()


def test_cp_attention_call_refusals(world1):
    q = torch.zeros((1, 6, 4, 8))
    with pytest.raises(ValueError, match="overlap_chunks=4 must divide"):
        tcx.cp_attention(q, q, q, world1, overlap_chunks=4, section="s")
    with pytest.raises(ValueError, match=">= 1"):
        tcx.cp_attention(q, q, q, world1, overlap_chunks=0)
    impl = tcx.cp_attention_impl(world1, section="s")
    seg = torch.zeros((1, 6), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="segment ids"):
        impl(q, q, q, segment_q=seg, segment_kv=seg)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        impl(q, q[:, :3], q[:, :3])
    # at cp 1 every mode is ulysses, which runs
    o = impl(q, q, q)
    assert o.shape == q.shape


@pytest.mark.parametrize("arch,par,match", [
    ("mamba2-130m", ParallelConfig(cp=2), "attention-free"),
    ("whisper-small", ParallelConfig(cp=2), "audio"),
    ("mixtral-8x22b", ParallelConfig(cp=2, pp=2), "pp x cp"),
    ("qwen1.5-0.5b", ParallelConfig(cp=2, cp_mode="ring"), "cp_mode"),
])
def test_section_cp_refusals_name_the_section(arch, par, match):
    cfg = tcfgs.get_reduced(arch)
    with pytest.raises((ValueError, NotImplementedError),
                       match=rf"section 'sec'.*{match}"):
        twl.validate_section_parallel("sec", cfg, par, twl._mesh_sizes(par))
    # cp runs, with tp too, and for the vlm family
    for name, ok in (("qwen1.5-0.5b", ParallelConfig(cp=2)),
                     ("mixtral-8x22b", ParallelConfig(cp=2, tp=2)),
                     ("pixtral-12b", ParallelConfig(cp=2))):
        assert twl.validate_section_parallel(
            "sec", tcfgs.get_reduced(name), ok,
            twl._mesh_sizes(ok)) == "cp"


def test_mllm_refuses_vit_shard_off_its_merge_and_lm_cp():
    lm = tcfgs.get_reduced("pixtral-12b").replace(
        dtype="float32", vocab_size=256, vision_dim=32, max_image_tokens=4)
    vit = vit_config(num_layers=2, d_model=32, num_heads=2, d_ff=64,
                     patch_dim=16, downsample=4, out_dim=32,
                     name="vit-tiny").replace(dtype="float32")
    shape = dict(global_batch=16, seq_len=32, mbs=4)
    with pytest.raises(ValueError, match="downsample factor 4"):
        tmw.mllm_spec(vit, lm, vit_parallel=ParallelConfig(cp=8),
                      lm_parallel=ParallelConfig(), **shape)
    # an LM at cp 2 runs (tests/test_torch_context_sections.py): its
    # image slots and the consumed embeddings stay whole on each sequence
    # rank, and its section validates in the cp regime
    spec = tmw.mllm_spec(vit, lm, vit_parallel=ParallelConfig(dp=2),
                         lm_parallel=ParallelConfig(dp=2, cp=2), **shape)
    llm = spec.section("llm")
    assert [k for k, f in llm.inputs.items() if not f.seq_split] == [
        "image_pos", "image_valid"]
    assert [c.seq_split for c in llm.consumes] == [False]
    assert twl.validate_section_parallel(
        "llm", llm.arch, llm.parallel, twl._mesh_sizes(llm.parallel)) == "cp"


def test_grad_compress_under_cp_section_raises():
    port = twl.Port("h", (twl.SEQ, 16), "float32")
    cfg = tcfgs.get_reduced("qwen1.5-0.5b")
    prod = twl.SectionSpec(
        "prod", cfg, ParallelConfig(dp=2, cp=2, grad_compress="bf16"),
        fn=lambda p, x: {"h": x["tokens"]}, params={},
        inputs={"tokens": twl.Field((twl.SEQ,), "int32")}, emits=(port,))
    crit = twl.SectionSpec(
        "crit", cfg, ParallelConfig(), fn=lambda p, x: x["prod.h"].sum(),
        params={}, consumes=(twl.Consume("prod", port),), loss=True,
        critical=True, inputs={"tokens": twl.Field((twl.SEQ,), "int32")})
    spec = twl.WorkloadSpec("t", (prod, crit))
    with pytest.raises(NotImplementedError,
                       match=r"section 'prod'.*plain regime"):
        twl.CompoundRuntime(spec, ranks=range(5))


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    jax_oracle(sys.argv[2], sys.argv[3])
