"""The hand-written kernels as ``torch.library`` custom ops
(``repro_torch::flash_fwd``, ``::flash_bwd``, ``::distill_kl_fwd``,
``::ssd_fwd``), on the CPU: an op called with CPU tensors raises (it is
registered for CUDA only; the plain versions are reached through
``kernels.ops`` and, for the backward, ``flash_attention.flash_bwd``);
each op's shape function gives the shapes, dtypes and strides of the
plain version's outputs (``chip_smoke.py`` holds them to a real launch's
on the card); a meta tensor (a dry-run's) goes down the kernel route
through ``ops``, forward and backward, and launches nothing; the flop
formulas are the counts ``PERF.md``'s bound column uses."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
