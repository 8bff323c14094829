"""The hand-written kernels as ``torch.library`` custom ops
(``repro_torch::flash_fwd``, ``::flash_bwd``, ``::distill_kl_fwd``,
``::distill_kl_bwd``, ``::ssd_fwd``, ``::ssd_bwd``), on the CPU: an op
called with CPU
tensors raises (it is registered for CUDA only; the plain versions are
reached through ``kernels.ops`` and, for the backward,
``flash_attention.flash_bwd``; the KL's backward on CPU tensors never
reaches its op or its wrapper, and the SSD scan's backward on CPU
tensors is autograd through ``ssd_chunked``);
each op's shape function gives the shapes, dtypes and strides of the
plain version's outputs (``chip_smoke.py`` holds them to a real launch's
on the card); a meta tensor (a dry-run's) goes down the kernel route
through ``ops``, forward and backward, and launches nothing; the flop
formulas are the counts ``PERF.md``'s bound column uses."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.kernels import distill_kl as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402


def _meta(x):
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device="meta")


def _same_layout(a, b):
    assert (a.shape, a.dtype, a.stride()) == (b.shape, b.dtype, b.stride())


@pytest.fixture
def flash_inputs():
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in ((2, 24, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16))]


def test_ops_refuse_cpu_tensors(flash_inputs):
    q, k, v = flash_inputs
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_fwd(q, k, v, None, True, 0, 0.25, 16)
    o, lse = ref.flash_attention_ref(q, k, v, causal=True, q_offset=16)
    o, lse = o.contiguous(), lse.contiguous()
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.flash_bwd(q, k, v, o, lse, o, lse, None, True,
                                        0, 0.25, 16)
    h, w = torch.zeros(4, 8), torch.zeros(8, 16)
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.distill_kl_fwd(h, w, h, w, 1.0)
    x = torch.zeros(1, 8, 2, 4)
    dt, A, B = torch.zeros(1, 8, 2), torch.zeros(2), torch.zeros(1, 8, 4)
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.ssd_fwd(x, dt, A, B, B, A, False)


def test_flash_shape_function_matches_plain_version(flash_inputs):
    q, k, v = flash_inputs
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=True,
                                             q_offset=16)
    o, lse = torch.ops.repro_torch.flash_fwd(*map(_meta, (q, k, v)), None,
                                             True, 0, 0.25, 16)
    _same_layout(o, o_ref.contiguous())
    _same_layout(lse, lse_ref.contiguous())
    # the backward's: dq, dk, dv as the plain version gives them
    want = ref.flash_bwd_ref(q, k, v, o_ref, lse_ref, o_ref, lse_ref,
                             causal=True, q_offset=16)
    got = torch.ops.repro_torch.flash_bwd(
        *map(_meta, (q, k, v, o_ref.contiguous(), lse_ref.contiguous(),
                     o_ref.contiguous(), lse_ref.contiguous())),
        None, True, 0, 0.25, 16)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_layout(g, w.contiguous())


def test_kl_shape_function_matches_plain_version():
    rng = np.random.default_rng(1)
    h_s, h_t = (torch.from_numpy(rng.standard_normal((12, d),
                                                     dtype=np.float32))
                for d in (8, 6))
    w_s, w_t = (torch.from_numpy(rng.standard_normal((d, 50),
                                                     dtype=np.float32))
                for d in (8, 6))
    want = ref.distill_kl_stats_ref(h_s, w_s, h_t, w_t, 2.0)
    got = dk.distill_kl_fwd(*map(_meta, (h_s, w_s, h_t, w_t)), 2.0)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)


def _kl_case(embed_t=False):
    rng = np.random.default_rng(3)
    N, Ds, Dt, V = 12, 8, 6, 50
    h_s, h_t = (torch.from_numpy(rng.standard_normal((N, d),
                                                     dtype=np.float32))
                for d in (Ds, Dt))
    w_s, w_t = (torch.from_numpy(rng.standard_normal(
        (V, d) if embed_t else (d, V), dtype=np.float32))
        for d in (Ds, Dt))
    if embed_t:                      # a tied embedding seen as [D, V]
        w_s, w_t = w_s.T, w_t.T
    return h_s, w_s, h_t, w_t


def test_kl_bwd_cpu_tensors_never_reach_the_op(monkeypatch):
    """CPU tensors: the KL's gradients come from the plain version, and
    neither the wrapper nor the op is called; both refuse CPU tensors."""
    h_s, w_s, h_t, w_t = _kl_case()
    stats = ref.distill_kl_stats_ref(h_s, w_s, h_t, w_t, 2.0)
    tok_w = torch.full((12,), 1.0 / 24)
    with pytest.raises(ValueError, match="distill_kl_bwd_ref"):
        dk.distill_kl_bwd(h_s, w_s, h_t, w_t, *stats, tok_w, 2.0)
    dz = torch.empty((1, 12, 128))
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.distill_kl_bwd(h_s, w_s, h_t, w_t, *stats,
                                             tok_w, dz, 0.5, True, True,
                                             False, False)

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached distill_kl_bwd")

    monkeypatch.setattr(dk, "distill_kl_bwd", refuse)
    leaves = [x.clone().requires_grad_() for x in (h_s, w_s)]
    kl = ops.distill_kl(*leaves, h_t, w_t, temperature=2.0)
    got = torch.autograd.grad(kl, leaves)
    want = ref.distill_kl_bwd_ref(h_s, w_s, h_t, w_t, *stats, tok_w, 2.0,
                                  needs=(True, True, False, False))
    for g, w in zip(got, want[:2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("embed_t", [False, True])
def test_kl_bwd_shape_function_matches_plain_version(embed_t):
    """The op's fake outputs (dh float32, dW like W, an output not asked
    for empty) against the plain version's, and meta tensors through
    ``ops.distill_kl``'s backward: meta gradients in the inputs' dtypes
    and W's strides, no launch."""
    xs = _kl_case(embed_t)
    stats = ref.distill_kl_stats_ref(*xs, 1.0)
    tok_w = torch.full((12,), 1.0 / 12)
    want = ref.distill_kl_bwd_ref(*xs, *stats, tok_w, 1.0)
    dz = torch.empty((2, 12, 128), device="meta")
    got = torch.ops.repro_torch.distill_kl_bwd(
        *map(_meta, (*xs, *stats, tok_w)), dz, 1.0, True, True, False, True)
    _same_layout(got[0], want[0])
    _same_layout(got[1], want[1])
    assert got[2].numel() == 0
    _same_layout(got[3], want[3])
    before = (dk.distill_kl_fwd.launches, dk.distill_kl_bwd.launches)
    leaves = [_meta(x).requires_grad_() for x in xs[:2]]
    kl = ops.distill_kl(*leaves, *map(_meta, xs[2:]), temperature=2.0)
    assert type(kl.grad_fn).__name__ == "DistillKLBackward"
    grads = torch.autograd.grad(kl, leaves)
    for g, x in zip(grads, xs[:2]):
        assert g.device.type == "meta"
        _same_layout(g, x)
    assert (dk.distill_kl_fwd.launches, dk.distill_kl_bwd.launches) == before


def test_kl_chunk_columns_fill_the_buffer_cap():
    """32768 columns at N = 8192 in bf16 (the buffer at its 512 MiB cap,
    five chunks over qwen's 151936), multiples of 128, no wider than V."""
    assert dk.chunk_cols(8192, 151936, torch.bfloat16) == 32768
    assert dk.chunk_cols(4096, 151936, torch.bfloat16) == 65536
    assert dk.chunk_cols(8192, 151936, torch.bfloat16, sides=2) == 16384
    assert dk.chunk_cols(8192, 151936, torch.float32) == 16384
    assert dk.chunk_cols(333, 5003, torch.bfloat16) == 5120
    assert dk.chunk_cols(10 ** 7, 151936, torch.bfloat16) == 128


def test_ssd_shape_function_matches_plain_version():
    rng = np.random.default_rng(2)
    b, s, h, p, n = 2, 70, 3, 8, 4
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh,  # noqa: E731
                                                         dtype=np.float32))
    x, dt, B, C = f(b, s, h, p), f(b, s, h).abs(), f(b, s, n), f(b, s, n)
    A, D = -f(h).abs(), f(h)
    y_ref, st_ref = ssd.ssd_chunked(x, dt, A, B, C, D, return_state=True)
    y, st = ssd.ssd_fwd(*map(_meta, (x, dt, A, B, C, D)), return_state=True)
    _same_layout(y, y_ref.contiguous())
    _same_layout(st, st_ref.contiguous())
    y_only = ssd.ssd_fwd(*map(_meta, (x, dt, A, B, C, D)))
    _same_layout(y_only, y)


def test_meta_tensors_take_the_kernel_route_without_a_launch(flash_inputs):
    q, k, v = (_meta(x).requires_grad_() for x in flash_inputs)
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches,
              ssd.ssd_fwd.launches)
    o = ops.flash_attention(q, k, v, causal=True)
    assert o.device.type == "meta" and o.shape == q.shape
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(o.sum(), (q, k, v))
    for g, x in zip(grads, (q, k, v)):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (x.shape, x.dtype)
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches,
            ssd.ssd_fwd.launches) == before


def test_flop_formulas_are_the_bound_counts():
    B, S, T, H, KV, D = 2, 24, 40, 4, 2, 16
    q = torch.empty((B, S, H, D), device="meta")
    k = torch.empty((B, T, KV, D), device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_fwd(q, k, k, None, True, 8, 0.25, 16)
    pairs = int(ref.visible_mask(S, T, causal=True, window=8,
                                 q_offset=16).sum())
    assert fc.get_total_flops() == 4 * B * H * D * pairs
    lse = torch.empty((B, S, H), device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_bwd(q, k, k, q, lse, q, None, None, True,
                                        8, 0.25, 16)
    assert fc.get_total_flops() == 10 * B * H * D * pairs
    with FlopCounterMode(display=False) as fc:   # explicit key positions
        torch.ops.repro_torch.flash_bwd(
            q, k, k, q, lse, q, lse,
            torch.empty((T,), dtype=torch.int32, device="meta"), True, 8,
            0.25, 16)
    assert fc.get_total_flops() == 10 * B * H * D * S * T
    N, Ds, Dt, V = 12, 8, 6, 50
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.distill_kl_fwd(
            torch.empty((N, Ds), device="meta"),
            torch.empty((Ds, V), device="meta"),
            torch.empty((N, Dt), device="meta"),
            torch.empty((Dt, V), device="meta"), 1.0)
    assert fc.get_total_flops() == 2 * N * V * (Ds + Dt)
    b, s, h, p, n = 2, 70, 3, 8, 4
    nc, Q = -(-s // ssd.CHUNK), ssd.CHUNK
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.ssd_fwd(
            torch.empty((b, s, h, p), device="meta"),
            torch.empty((b, s, h), device="meta"),
            torch.empty((h,), device="meta"),
            torch.empty((b, s, n), device="meta"),
            torch.empty((b, s, n), device="meta"),
            torch.empty((h,), device="meta"), False)
    assert fc.get_total_flops() == (2 * b * nc * Q * Q * n
                                    + 2 * b * h * nc * Q * Q * p
                                    + 4 * b * h * s * p * n)


@pytest.mark.parametrize("needs", [(True, True, False, False),
                                   (True, False, False, False),
                                   (True, True, True, True)])
def test_kl_bwd_flop_formula_is_the_bound_count(needs):
    """2 N V (Ds + Dt) for the recomputed logits, 2 N V D for each of dh
    and dW asked for: 2 N V (Ds + Dt) + 4 N V Ds on the student side."""
    N, Ds, Dt, V = 12, 8, 6, 50
    m = lambda *sh: torch.empty(sh, device="meta")  # noqa: E731
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.distill_kl_bwd(
            m(N, Ds), m(Ds, V), m(N, Dt), m(Dt, V), *(m(N) for _ in range(5)),
            m(1 + needs[2], N, 128), 1.0, *needs)
    want = 2 * N * V * (Ds + Dt + (needs[0] + needs[1]) * Ds
                        + (needs[2] + needs[3]) * Dt)
    assert fc.get_total_flops() == want
    if needs == (True, True, False, False):
        assert want == 2 * N * V * (Ds + Dt) + 4 * N * V * Ds


class _Calls(TorchDispatchMode):
    """The ops dispatched under it, by name, with the shapes and dtypes of
    the ``empty`` allocations among them."""

    def __init__(self):
        super().__init__()
        self.names, self.empties = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.names.append(str(func))
        if func is torch.ops.aten.empty.memory_format:
            self.empties.append((tuple(args[0]), kwargs.get("dtype")))
        return out


def _ssd_case(b=2, s=70, h=3, p=8, n=4, dtype=torch.float32):
    rng = np.random.default_rng(4)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(  # noqa: E731
        sh, dtype=np.float32))
    x, B, C = (f(*sh).to(dtype) for sh in ((b, s, h, p), (b, s, n),
                                          (b, s, n)))
    return (x, f(b, s, h).abs(), -f(h).abs(), B, C, f(h),
            f(b, s, h, p).to(dtype), f(b, h, p, n))


def test_ssd_bwd_op_is_registered_and_refuses_cpu_tensors():
    """The op exists for CUDA only; the wrapper refuses CPU tensors (they
    go to ``ref.ssd_bwd_ref``) and a call that autograd would record."""
    assert hasattr(torch.ops.repro_torch, "ssd_bwd")
    x, dt, A, B, C, D, gy, gs = _ssd_case()
    n_cum, n_work = ssd.bwd_scratch(2, 70, 3, 8, 4, torch.float32)
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.ssd_bwd(
            x, dt, A, B, C, D, gy, gs,
            torch.empty(n_cum, dtype=torch.float64), torch.empty(n_work))
    with pytest.raises(ValueError, match="ssd_bwd_ref"):
        ssd.ssd_bwd(x, dt, A, B, C, D, gy, gs)
    with pytest.raises(RuntimeError, match="ops.ssd_scan"):
        ssd.ssd_bwd(x.clone().requires_grad_(), dt, A, B, C, D, gy, gs)
    with torch.no_grad():                    # refused for its device then
        with pytest.raises(ValueError, match="CUDA"):
            ssd.ssd_bwd(x.clone().requires_grad_(), dt, A, B, C, D, gy, gs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_bwd_shape_function_allocates_outputs_and_scratch(dtype,
                                                              with_state):
    """On meta tensors the wrapper allocates the scratch of
    ``bwd_scratch`` (float64 cum, float32 work: the states entering and
    the gradients leaving each chunk, in float32 for float32 inputs and as
    bf16 hi and lo parts of p and n padded to 64 for bf16 ones, whose work
    also holds the head groups' dB/dC partials; the dA/dD partials) and
    the op's fake function the six gradients, laid out as the plain
    version's: dx, dB, dC in x's dtype, ddt, dA, dD float32.  Nothing is
    launched."""
    x, dt, A, B, C, D, gy, gs = _ssd_case(dtype=dtype)
    want = ref.ssd_bwd_ref(x, dt, A, B, C, D, gy, gs if with_state else None)
    before = ssd.ssd_bwd.launches
    with _Calls() as calls:
        got = ssd.ssd_bwd(*map(_meta, (x, dt, A, B, C, D, gy)),
                          _meta(gs) if with_state else None)
    assert ssd.ssd_bwd.launches == before
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        _same_layout(g, w.contiguous())
    n_cum, n_work = ssd.bwd_scratch(2, 70, 3, 8, 4, dtype)
    nc = -(-70 // ssd.CHUNK)
    if dtype == torch.float32:
        assert (n_cum, n_work) == (2 * 3 * nc * ssd.CHUNK,
                                   2 * 2 * 3 * nc * 8 * 4 + 2 * 2 * nc * 3)
    else:   # one group of 3 heads
        assert (n_cum, n_work) == (0, 2 * 2 * 3 * nc * 64 * 64
                                   + 2 * 1 * 2 * 70 * 4 + 2 * 2 * nc * 3)
    assert ((n_cum,), torch.float64) in calls.empties
    assert ((n_work,), torch.float32) in calls.empties
    assert calls.names.count("repro_torch.ssd_bwd.default") == 1


def test_ssd_bwd_flop_formula_is_the_bound_count():
    """10 Q p n a (b, h, chunk) for the chunk states, G_c and the H and dH
    products, 2 Q^2 n a (b, chunk) for C B^T, 4 Q^2 (p + n) a (b, h,
    chunk) for G, W^T gy, dS B and dS^T C; ~52 GFLOP at mamba2-130m's
    (4, 4096, 24, 64, 128)."""
    def flops(b, s, h, p, n):
        m = lambda *sh: torch.empty(sh, device="meta")  # noqa: E731
        with FlopCounterMode(display=False) as fc:
            torch.ops.repro_torch.ssd_bwd(
                m(b, s, h, p), m(b, s, h), m(h), m(b, s, n), m(b, s, n),
                m(h), m(b, s, h, p), None,
                torch.empty((1,), dtype=torch.float64, device="meta"), m(1))
        return fc.get_total_flops()

    b, s, h, p, n = 2, 70, 3, 8, 4
    nc, Q = -(-s // ssd.CHUNK), ssd.CHUNK
    assert flops(b, s, h, p, n) == (10 * b * h * nc * Q * p * n
                                    + 2 * b * nc * Q * Q * n
                                    + 4 * b * h * nc * Q * Q * (p + n))
    assert 51e9 < flops(4, 4096, 24, 64, 128) < 53e9


def test_ssd_meta_backward_records_the_kernel_op_without_a_launch():
    """Meta tensors through ``ops.ssd_scan``'s backward: the op
    ``repro_torch::ssd_bwd`` is what autograd runs (no ``ssd_chunked``
    recompute, whose einsums would show), the gradients are meta tensors
    in each leaf's dtype, and no kernel is launched."""
    x, dt, A, B, C, D, gy, gs = _ssd_case(dtype=torch.bfloat16)
    leaves = [_meta(t).requires_grad_() for t in (x, dt, A, B, C, D)]
    before = (ssd.ssd_fwd.launches, ssd.ssd_bwd.launches)
    y, state = ops.ssd_scan(*leaves, return_state=True)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    with _Calls() as calls:
        grads = torch.autograd.grad((y, state), leaves, (_meta(gy), _meta(gs)))
    assert "repro_torch.ssd_bwd.default" in calls.names
    assert not any("einsum" in n or "cumsum" in n for n in calls.names)
    for g, leaf in zip(grads, leaves):
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (leaf.shape, leaf.dtype)
    assert (ssd.ssd_fwd.launches, ssd.ssd_bwd.launches) == before
