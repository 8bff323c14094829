"""The port's SSD scan against the JAX package, on the CPU in float32.

* ``ssd_chunked`` against ``ssd_chunked_jnp`` over
  ``tests/test_kernels_ssd.py``'s sweep, ``ssd_reference`` against
  ``repro.kernels.ref.ssd_reference``;
* ``ssd_decode_step`` against JAX's, and token-by-token decode against the
  scan; the initial-state continuation;
* the kernel's plain version ``ssd_scan_ref`` (fixed 64-token chunk, final
  state) against ``ssd_chunked_jnp(..., return_state=True)``;
* :class:`SSDScan` with the plain forward standing in for the CUDA one:
  its gradients against ``jax.grad`` through ``ssd_scan_pallas`` in
  interpret mode;
* ROADMAP.md C3: at chunk 128 with the model's init (A = -1) the JAX
  chunked gradients are non-finite; the port's are finite and equal
  ``jax.grad`` through the sequential oracle.

Inputs are made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import ssd_scan as jssd  # noqa: E402
from repro.kernels.ssd_pallas import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

# float32 on both sides, sums in other orders: tests/test_kernels_ssd.py's
# 1e-4 for outputs, 1e-3 for states (sums of up to s products)
TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-3, rtol=1e-3)
# gradients pass through the backward's sums as well: test_kernels_ssd.py's
# 2e-3 for the Pallas gradients against the oracle's
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
SWEEP = [(2, 64, 3, 8, 16), (1, 128, 2, 16, 8), (2, 48, 4, 8, 4)]


def _inputs(b, s, h, p, n, seed=1, A=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32)))
    if A is None:
        A = -np.exp(rng.standard_normal(h).astype(np.float32))
    else:
        A = np.full(h, A, np.float32)
    B = rng.standard_normal((b, s, n), dtype=np.float32)
    C = rng.standard_normal((b, s, n), dtype=np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B, C, D


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                             for a in arrs])


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(want), **tol)


@pytest.mark.parametrize("b,s,h,p,n", SWEEP)
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_chunked_matches_jax(b, s, h, p, n, chunk):
    j, t = _both(_inputs(b, s, h, p, n))
    _close(ssd.ssd_chunked(*t, chunk=chunk),
           jssd.ssd_chunked_jnp(*j, chunk=chunk))


@pytest.mark.parametrize("b,s,h,p,n", SWEEP[:2])
def test_sequential_reference_matches_jax(b, s, h, p, n):
    j, t = _both(_inputs(b, s, h, p, n))
    _close(ref.ssd_reference(*t), jref.ssd_reference(*j))


def test_decode_step_matches_jax_and_the_scan():
    b, s, h, p, n = 2, 32, 3, 8, 16
    j, t = _both(_inputs(b, s, h, p, n))
    x, dt, A, B, C, D = t
    y_full, state_full = ssd.ssd_chunked(*t, chunk=8, return_state=True)
    state = torch.zeros(b, h, p, n)
    jstate = jnp.zeros((b, h, p, n), jnp.float32)
    ys = []
    for i in range(s):
        state, yt = ssd.ssd_decode_step(state, x[:, i], dt[:, i], A,
                                        B[:, i], C[:, i], D)
        jstate, jyt = jssd.ssd_decode_step(jstate, j[0][:, i], j[1][:, i],
                                           j[2], j[3][:, i], j[4][:, i],
                                           j[5])
        _close(yt, jyt, dict(atol=1e-5, rtol=1e-5))
        ys.append(yt)
    _close(state, jstate, dict(atol=1e-5, rtol=1e-5))
    _close(torch.stack(ys, dim=1), y_full.numpy())
    _close(state, state_full.numpy(), STATE_TOL)


def test_initial_state_continuation():
    x, dt, A, B, C, D = _both(_inputs(1, 64, 2, 8, 8))[1]
    y_full = ssd.ssd_chunked(x, dt, A, B, C, D, chunk=16)
    y1, st = ssd.ssd_chunked(x[:, :32], dt[:, :32], A, B[:, :32],
                             C[:, :32], D, chunk=16, return_state=True)
    y2 = ssd.ssd_chunked(x[:, 32:], dt[:, 32:], A, B[:, 32:], C[:, 32:], D,
                         chunk=16, initial_state=st)
    _close(torch.cat([y1, y2], dim=1), y_full.numpy())


@pytest.mark.parametrize("b,s,h,p,n", SWEEP + [(1, 200, 2, 8, 8)])
def test_kernel_plain_version_matches_jax_with_state(b, s, h, p, n):
    """The fixed 64-token chunk with the ragged tail padded gives JAX's y
    and final state (JAX at its own chunk rule)."""
    j, t = _both(_inputs(b, s, h, p, n))
    y, state = ref.ssd_scan_ref(*t, return_state=True)
    jy, jstate = jssd.ssd_chunked_jnp(*j, chunk=64, return_state=True)
    _close(y, jy)
    _close(state, jstate, STATE_TOL)


def _plain_forward(x, dt, A, B, C, D, *, return_state):
    assert not torch.is_grad_enabled()
    return ref.ssd_scan_ref(x, dt, A, B, C, D, return_state=return_state)


@pytest.mark.parametrize("chunk", [8, 16])
def test_function_gradients_match_jax_pallas(chunk):
    """test_kernels_ssd.py::test_pallas_grads with every input's gradient
    and the Function's forward in the kernel's place."""
    arrs = _inputs(1, 32, 2, 8, 8)
    j, t = _both(arrs)
    g = np.random.default_rng(2).standard_normal(arrs[0].shape,
                                                 dtype=np.float32)
    want = jax.grad(lambda *a: jnp.sum(ssd_scan_pallas(
        *a, chunk=chunk, interpret=True) * g), argnums=tuple(range(6)))(*j)
    leaves = [x.requires_grad_() for x in t]
    y = ssd.SSDScan.apply(*leaves, chunk, False, _plain_forward)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), leaves)
    for gp, gj in zip(got, want):
        _close(gp, gj, GRAD_TOL)


def test_function_state_cotangent_and_partial_grads():
    arrs = _inputs(2, 48, 2, 8, 4)
    t = [torch.from_numpy(a) for a in arrs]
    x, dt, A, B, C, D = t
    gy = torch.randn(2, 48, 2, 8, generator=torch.Generator().manual_seed(0))
    gs = torch.randn(2, 2, 8, 4, generator=torch.Generator().manual_seed(1))
    for leaf in (x, B):
        leaf.requires_grad_()
    y, state = ssd.SSDScan.apply(x, dt, A, B, C, D, 16, True, _plain_forward)
    got = torch.autograd.grad((y * gy).sum() + (state * gs).sum(), [x, B])
    y_r, state_r = ssd.ssd_chunked(x, dt, A, B, C, D, chunk=16,
                                   return_state=True)
    want = torch.autograd.grad((y_r * gy).sum() + (state_r * gs).sum(),
                               [x, B])
    for a, b in zip(got, want):
        _close(a, b.numpy(), dict(atol=1e-4, rtol=1e-4))


def test_cpu_ops_take_the_plain_version_and_the_wrapper_refuses():
    t = [torch.from_numpy(a) for a in _inputs(1, 40, 2, 8, 4)]
    before = ssd.ssd_fwd.launches
    y, state = ops.ssd_scan(*t, chunk=8, return_state=True)
    y_r, state_r = ssd.ssd_chunked(*t, chunk=8, return_state=True)
    assert torch.equal(y, y_r) and torch.equal(state, state_r)
    assert ssd.ssd_fwd.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_fwd(*t)
    x = t[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="ops.ssd_scan"):
        ssd.ssd_fwd(x, *t[1:])


def test_c3_jax_chunked_grads_are_nan_where_the_port_is_finite():
    """ROADMAP.md C3: chunk 128, dt = softplus(N(0,1)), A = -1 (the model's
    init, A_log = 0).  Above the diagonal exp(cum_i - cum_j) overflows;
    JAX's where() keeps its forward right and its gradient NaN.  The port
    masks before the exp."""
    arrs = _inputs(1, 256, 2, 8, 16, seed=0, A=-1.0)
    j, t = _both(arrs)
    g = np.random.default_rng(3).standard_normal(arrs[0].shape,
                                                 dtype=np.float32)

    def jloss(fn):
        return lambda *a: jnp.sum(fn(*a) * g)

    argn = tuple(range(6))
    jgrads = jax.grad(jloss(lambda *a: jssd.ssd_chunked_jnp(
        *a, chunk=128)), argnums=argn)(*j)
    assert not all(bool(jnp.isfinite(x).all()) for x in jgrads)
    want = jax.grad(jloss(jref.ssd_reference), argnums=argn)(*j)
    assert all(bool(jnp.isfinite(x).all()) for x in want)
    leaves = [x.requires_grad_() for x in t]
    for y in (ssd.ssd_chunked(*leaves, chunk=128),
              ssd.SSDScan.apply(*leaves, 128, False, _plain_forward)):
        _close(y, jssd.ssd_chunked_jnp(*j, chunk=128))
        got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), leaves)
        for gp, gj in zip(got, want):
            assert bool(torch.isfinite(gp).all())
            # relative to the gradient's scale: dA sums 256 * 8 terms
            scale = float(jnp.abs(gj).max())
            _close(gp, gj, dict(atol=2e-3 * max(scale, 1.0), rtol=2e-3))
