"""The CUDA SSD chunked-scan kernel's source, run on the CPU.

``src/repro_torch/kernels/csrc/ssd_fwd.cu`` (its three ``__global__``s: the
chunk states, the sequential pass over chunks and the chunk outputs) is
compiled with ``g++`` against the stand-in CUDA headers of
``tests/torch_cuda_emu.py`` and called with CPU tensors through the
wrapper's own C signature.  y and the final state are held against the
plain version, ``ssd_scan_ref``: a ragged last chunk, lengths below one
chunk, p and n below and above one 64-wide tile, more chunks than the
state pass loads at once, x, B and C as strided slices of one tensor (as
the model passes them), f32 and bf16.
"""
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
    (2, 64, 3, 8, 16, torch.float32, False),      # one whole chunk
    (1, 200, 2, 16, 8, torch.float32, True),      # ragged: 3 chunks + 8
    (2, 48, 4, 8, 4, torch.bfloat16, True),       # shorter than a chunk
    (1, 130, 2, 80, 72, torch.float32, False),    # p, n past one tile
    (1, 192, 1, 64, 128, torch.bfloat16, False),  # mamba2-130m's p, n
    (1, 1093, 1, 8, 4, torch.float32, True),      # 18 chunks: two batches
]


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


def _run(lib, x, dt, A, B, C, D, with_state=True):
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = -(-s // ssd.CHUNK)
    y = torch.full((b, s, h, p), float("nan"), dtype=x.dtype)
    cum = torch.full((b, h, nc, ssd.CHUNK), float("nan"))
    states = torch.full((b, h, nc, p, n), float("nan"))
    state = torch.full((b, h, p, n), float("nan"))
    err = lib.ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), cum.data_ptr(),
        states.data_ptr(), state.data_ptr() if with_state else None,
        b, s, h, p, n, x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
        dt.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        ssd._DTYPES[x.dtype], None)
    return err, y, state


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    map(str, c[:5])) + f"-{str(c[5])[6:]}" + ("-packed" if c[6] else ""))
def test_kernel_source_matches_plain_version(lib, case):
    x, dt, A, B, C, D = _inputs(*case)
    err, y, state = _run(lib, x, dt, A, B, C, D)
    assert err == 0
    y_ref, state_ref = ssd_scan_ref(x, dt, A, B, C, D, return_state=True)
    torch.testing.assert_close(y.float(), y_ref.float(), **TOL[x.dtype])
    torch.testing.assert_close(state, state_ref, **STATE_TOL)


def test_kernel_source_without_final_state_and_bad_dims(lib):
    x, dt, A, B, C, D = _inputs(1, 100, 2, 8, 8, torch.float32, False)
    err, y, state = _run(lib, x, dt, A, B, C, D, with_state=False)
    assert err == 0 and bool(torch.isnan(state).all())     # left untouched
    torch.testing.assert_close(y, ssd_scan_ref(x, dt, A, B, C, D),
                               **TOL[torch.float32])
    xb = torch.zeros(1, 8, 1, ssd.MAX_P + 1)
    bad = _run(lib, xb, dt[:, :8, :1], A[:1], B[:, :8], C[:, :8],
               D[:1])[0]
    assert bad != 0
