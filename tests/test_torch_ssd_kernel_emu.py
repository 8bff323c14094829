"""The CUDA SSD chunked-scan kernel's source, run on the CPU.

``src/repro_torch/kernels/csrc/ssd_fwd.cu`` is compiled with ``g++``
against the stand-in CUDA headers of ``tests/torch_cuda_emu.py`` (its
``hopper.cuh`` stand-in included) and called with CPU tensors through the
wrapper's own C signature.  float32 cases run its three CUDA-core kernels
(chunk states, the pass over chunks, chunk outputs), bf16 cases its two
tensor-core kernels (the states entering each chunk, carried in a wgmma
accumulator; the chunk outputs with C B^T shared by a group of heads).  y
and the final state are held against the plain version, ``ssd_scan_ref``:
a ragged last chunk, lengths below one chunk, p and n below and above one
64-wide tile (padded to 64 or 128 on the tensor cores), more chunks than
the pass loads at once or the state kernel's ring holds, x, B and C as
strided slices of one tensor (as the model passes them), tensors that TMA
refuses (loaded by threads), and the threads' route against TMA's.
"""
import contextlib
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cuda_emu  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref  # noqa: E402

# float32: the kernel and the plain version sum the same products in other
# orders (n-long dot products, 64-token chunks, up to a few chunk states):
# 1e-4 on outputs of magnitude ~10.  bf16: both sides compute in float32
# from the same bf16 inputs and round y once, so they differ by at most one
# bf16 step where the float32 sums fall on either side of a rounding
# boundary: 1/128 relative.
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=2 ** -7)}
STATE_TOL = dict(atol=1e-4, rtol=1e-4)

CASES = [
    # b, s, h, p, n, dtype, packed (x, B, C sliced from one tensor)
    # float32: the three CUDA-core kernels
    (2, 64, 3, 8, 16, torch.float32, False),      # one whole chunk
    (1, 200, 2, 16, 8, torch.float32, True),      # ragged: 3 chunks + 8
    (1, 130, 2, 80, 72, torch.float32, False),    # p, n past one tile
    (1, 1093, 1, 8, 4, torch.float32, True),      # 18 chunks: two batches
    # bf16: the tensor-core kernels
    (2, 48, 4, 8, 4, torch.bfloat16, True),       # shorter than a chunk;
    #   C at byte 72 of a row: TMA refuses it, the tiles load by threads
    (1, 192, 1, 64, 128, torch.bfloat16, False),  # mamba2-130m's p, n
    (1, 200, 2, 64, 128, torch.bfloat16, True),   # packed as the model; ragged
    (1, 40, 3, 64, 128, torch.bfloat16, True),    # packed, below one chunk
    (1, 130, 3, 80, 72, torch.bfloat16, False),   # p, n padded to 128
    (2, 48, 4, 8, 4, torch.bfloat16, False),      # p, n padded to 64; B rows
    #   of 8 bytes: TMA refuses them
    (1, 581, 26, 16, 32, torch.bfloat16, False),  # 10 chunks through a ring
    #   of 4; 26 heads: a group of 24 and one of 2
    (1, 70, 2, 5, 12, torch.bfloat16, False),     # odd p: y one bf16 at a
    #   time; rows of 10 and 24 bytes: loaded by threads
]


def _ref(*args, **kw):
    """``ssd_scan_ref`` on one CPU thread.  With several, MKL may pick
    another blocking of its float32 products from one run to the next (as
    the machine's load changes), and at (2, 64, 3, 8, 16) one run in about
    ten then moves y by ~1e-3, where the usual blocking agrees with the
    kernel within 5e-5: the oracle must not depend on the load."""
    with _one_thread():
        return ssd_scan_ref(*args, **kw)


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = torch_cuda_emu.build("ssd_fwd", tmp_path_factory.mktemp("ssd_emu"))
    lib.ssd_fwd.argtypes = ssd._ARGTYPES
    lib.ssd_fwd.restype = ctypes.c_int
    return lib


def _inputs(b, s, h, p, n, dtype, packed, seed=0):
    rng = np.random.default_rng(seed)
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((b, s, h), dtype=np.float32))))
    A = torch.from_numpy(-np.exp(rng.standard_normal(h).astype(np.float32)))
    D = torch.from_numpy(rng.standard_normal(h).astype(np.float32))
    if packed:      # [b, s, h*p + 2n] as the model's conv output
        xbc = torch.from_numpy(rng.standard_normal(
            (b, s, h * p + 2 * n), dtype=np.float32)).to(dtype)
        x = xbc[..., :h * p].unflatten(-1, (h, p))
        B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x, B, C = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dtype)
            for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    return x, dt, A, B, C, D


def _run(lib, x, dt, A, B, C, D, with_state=True, tma=None):
    """The C entry point as the wrapper calls it; ``tma`` (bf16) defaults
    to the wrapper's choice, ``ssd.tma_route``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if tma is None:
        tma = x.dtype == torch.bfloat16 and ssd.tma_route(x, B, C)
    y = torch.full((b, s, h, p), float("nan"), dtype=x.dtype)
    n_cum, n_states = ssd.scratch(b, s, h, p, n, x.dtype)
    cum = torch.full((max(n_cum, 1),), float("nan"))
    states = torch.full((n_states,), float("nan"))
    state = torch.full((b, h, p, n), float("nan"))
    err = lib.ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), cum.data_ptr(),
        states.data_ptr(), state.data_ptr() if with_state else None,
        b, s, h, p, n, x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
        dt.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        ssd._DTYPES[x.dtype], int(tma), None)
    return err, y, state


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    map(str, c[:5])) + f"-{str(c[5])[6:]}" + ("-packed" if c[6] else ""))
def test_kernel_source_matches_plain_version(lib, case):
    x, dt, A, B, C, D = _inputs(*case)
    err, y, state = _run(lib, x, dt, A, B, C, D)
    assert err == 0
    y_ref, state_ref = _ref(x, dt, A, B, C, D, return_state=True)
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL[x.dtype])
    torch.testing.assert_close(state, state_ref, **STATE_TOL)


def test_kernel_source_without_final_state_and_bad_dims(lib):
    x, dt, A, B, C, D = _inputs(1, 100, 2, 8, 8, torch.float32, False)
    err, y, state = _run(lib, x, dt, A, B, C, D, with_state=False)
    assert err == 0 and bool(torch.isnan(state).all())     # left untouched
    torch.testing.assert_close(y, _ref(x, dt, A, B, C, D),
                               **TOL[torch.float32])
    xb = torch.zeros(1, 8, 1, ssd.MAX_P + 1)
    bad = _run(lib, xb, dt[:, :8, :1], A[:1], B[:, :8], C[:, :8],
               D[:1])[0]
    assert bad != 0


def test_bf16_route_follows_the_tma_preconditions(lib):
    """The wrapper loads by TMA exactly where every one of x, B and C meets
    TMA's preconditions, and the threads' route gives the same bits."""
    packed = _inputs(1, 200, 2, 64, 128, torch.bfloat16, True)
    assert ssd.tma_route(packed[0], packed[3], packed[4])
    for case in ((2, 48, 4, 8, 4, torch.bfloat16, True),
                 (2, 48, 4, 8, 4, torch.bfloat16, False)):
        x, _, _, B, C, _ = _inputs(*case)
        assert not ssd.tma_route(x, B, C)
    by_tma = _run(lib, *packed, tma=True)
    by_threads = _run(lib, *packed, tma=False)
    assert by_tma[0] == by_threads[0] == 0
    assert torch.equal(by_tma[1], by_threads[1])
    assert torch.equal(by_tma[2], by_threads[2])
    y_ref, state_ref = _ref(*packed, return_state=True)
    torch.testing.assert_close(by_threads[1].float(), y_ref.float(),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(by_threads[2], state_ref, **STATE_TOL)


def test_bf16_without_final_state(lib):
    x, dt, A, B, C, D = _inputs(1, 100, 2, 64, 128, torch.bfloat16, True)
    err, y, state = _run(lib, x, dt, A, B, C, D, with_state=False)
    assert err == 0 and bool(torch.isnan(state).all())     # left untouched
    torch.testing.assert_close(y.float(),
                               _ref(x, dt, A, B, C, D).float(),
                               **TOL[torch.bfloat16])
