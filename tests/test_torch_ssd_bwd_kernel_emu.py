"""The CUDA SSD backward kernel's source, run on the CPU.

``src/repro_torch/kernels/csrc/ssd_bwd.cu`` is compiled with ``g++``
against the stand-in CUDA headers of ``tests/torch_cuda_emu.py`` (its
``hopper.cuh`` stand-in included) and called with CPU tensors through the
wrapper's own C signature, with the scratch sizes of
``ssd_scan.bwd_scratch``.  float32 cases run its four CUDA-core kernels
(the chunk states and G_c, the forward and reverse passes over the chunks,
the chunks' gradients with every head of a (chunk, b) in one block, the
sums of the dA and dD partials), bf16 cases its three tensor-core kernels
(the two walks over the chunks with the carry in a wgmma accumulator; the
chunks' gradients for a group of heads, over a ring of stages; the sums of
the groups' dB/dC and the dA/dD partials).  Each output is held against
the plain version ``ref.ssd_bwd_ref``: lengths below, at and above one
64-token chunk and ragged; p and n below and above one 64-wide tile
(padded to 64 or 128 on the tensor cores, jamba's n = 16 too);
mamba2-130m's p and n; more chunks than the state kernel's ring holds;
more heads than the gradient kernel's ring, a whole and a partial group;
with and without the final state's gradient; x, B and C as strided slices
of one tensor (as the model passes them); tensors that TMA refuses (loaded
by threads), and the threads' route against TMA's.  Two calls give the
same bits, and a source with a planted fault fails the comparison: the
reverse pass started from zero instead of gstate (the dH carried into the
last chunk), the carry into chunk 0 (the last one the reverse pass
reaches) dropped, or (tensor cores) the lo part of every dH dropped.
"""
import contextlib
import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cuda_emu  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import ssd_bwd_ref  # noqa: E402

# test_torch_ssd_kernel_emu.py's TOL.  float32: the kernel and the plain
# version sum the same products in other orders (n- and p-long dot
# products, 64-token chunks, a few chunk states).  bf16: both sides compute
# in float32 from the same bf16 inputs and round dx, dB and dC once, so
# they differ by at most one bf16 step where the float32 sums fall on
# either side of a rounding boundary; ddt, dA and dD are float32 on both
# sides, held to the float32 limit.  A float32 output's atol is taken
# relative to its leaf's largest element (times max(1, max|ref|)): ddt
# sums terms of either sign up to ~1e3 at p = 64, n = 128, and one f32
# rounding of those is ~1e-4 of an element that cancels to ~0.1.
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-2, rtol=2 ** -7)}
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")

# A = -a exp(N(0, 1)): at a = 1 most heads decay to nothing within a chunk
# (exp(cum_end) ~ e^-45), so the carries between chunks barely move the
# gradients; at a = 0.02 a chunk keeps ~0.4 of its state, and the forward
# and reverse passes carry real weight
CASES = [
    # b, s, h, p, n, dtype, packed (x, B, C sliced from one tensor), gstate, a
    (2, 64, 3, 8, 16, torch.float32, False, False, 1.0),   # one whole chunk
    (1, 200, 2, 16, 8, torch.float32, True, True, 0.02),   # ragged: 3 + 8
    (1, 130, 2, 80, 72, torch.float32, False, True, 0.02),  # p, n past a tile
    (2, 40, 3, 8, 4, torch.float32, True, False, 1.0),     # below one chunk
    (1, 1030, 1, 8, 4, torch.float32, False, True, 0.02),  # 17 chunks: two
    #   batches of the pass's loads
    # bf16: the tensor-core kernels
    (2, 48, 4, 8, 4, torch.bfloat16, True, True, 1.0),     # below one chunk;
    #   C at byte 72 of a row: TMA refuses it, the tiles load by threads
    (1, 192, 2, 64, 128, torch.bfloat16, True, True, 0.02),  # mamba2-130m's
    #   p, n, packed as the model
    (1, 130, 1, 80, 72, torch.bfloat16, False, False, 0.02),  # p, n padded
    #   to 128
    (1, 200, 4, 64, 16, torch.bfloat16, True, False, 0.02),  # jamba's p, n
    #   (n padded to 64), packed as the model: B and C 32 bytes wide, by TMA
    (1, 300, 1, 16, 8, torch.bfloat16, True, True, 0.02),  # 5 chunks
    #   through the state kernel's ring of 4; ragged
    (1, 40, 10, 8, 16, torch.bfloat16, False, True, 0.02),  # 10 heads: a
    #   group of 8 through a ring of 2 stages, and one of 2
]


@contextlib.contextmanager
def _one_thread():
    """The oracle on one CPU thread: with several, MKL may pick another
    blocking of its float32 products from one run to the next (as the
    machine's load changes), and the oracle must not depend on the load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _build(out, src=None):
    lib = torch_cuda_emu.build("ssd_bwd", out, src)
    lib.ssd_bwd.argtypes = ssd._BWD_ARGTYPES
    lib.ssd_bwd.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The source and each planted fault's (``PLANTED``), compiled at
    once: {"good": lib, fault: lib}."""
    src = (torch_cuda_emu.CSRC / "ssd_bwd.cu").read_text()
    srcs = {"good": None}
    for fault, (line, planted, _) in PLANTED.items():
        assert src.count(line) == 1, f"{line!r} is no longer in ssd_bwd.cu"
        srcs[fault] = src.replace(line, planted)
    outs = [tmp_path_factory.mktemp(f"ssd_bwd_{name}") for name in srcs]
    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(zip(srcs, pool.map(_build, outs, srcs.values())))


@pytest.fixture(scope="module")
def lib(libs):
    return libs["good"]


def _inputs(b, s, h, p, n, dtype, packed, with_state, a=1.0, seed=0):
    rng = np.random.default_rng(seed)
    dt = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((b, s, h), dtype=np.float32))))
    A = torch.from_numpy(-a * np.exp(rng.standard_normal(h).astype(
        np.float32)))
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
    gy = torch.from_numpy(rng.standard_normal((b, s, h, p),
                                              dtype=np.float32)).to(dtype)
    gstate = (torch.from_numpy(rng.standard_normal((b, h, p, n),
                                                   dtype=np.float32))
              if with_state else None)
    return x, dt, A, B, C, D, gy, gstate


def _run(lib, x, dt, A, B, C, D, gy, gstate=None, tma=None):
    """The C entry point as the op calls it, every output and the scratch
    NaN-filled first; ``tma`` (bf16) defaults to the wrapper's choice,
    ``ssd.tma_route``."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if tma is None:
        tma = x.dtype == torch.bfloat16 and ssd.tma_route(x, B, C, gy)
    n_cum, n_work = ssd.bwd_scratch(b, s, h, p, n, x.dtype)
    cum = torch.full((max(n_cum, 1),), float("nan"), dtype=torch.float64)
    work = torch.full((n_work,), float("nan"))
    outs = [t.fill_(float("nan")) for t in ssd._bwd_outputs(x, B)]
    err = lib.ssd_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), gy.data_ptr(),
        None if gstate is None else gstate.data_ptr(),
        *(t.data_ptr() for t in outs), cum.data_ptr(), work.data_ptr(),
        b, s, h, p, n, x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
        dt.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        ssd._DTYPES[x.dtype], int(tma), None)
    return err, outs


def _ref(*args):
    with _one_thread():
        return ssd_bwd_ref(*args)


def _assert_matches(got, want, dtype):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        tol = dict(TOL[dtype if g.dtype == dtype else torch.float32])
        if g.dtype == torch.float32:
            tol["atol"] *= max(1.0, w.abs().max().item())
        torch.testing.assert_close(g.float(), w.float(), **tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    map(str, c[:5])) + f"-{str(c[5])[6:]}" + ("-packed" if c[6] else "")
    + ("-gstate" if c[7] else ""))
def test_kernel_source_matches_plain_version(lib, case):
    ins = _inputs(*case)
    err, got = _run(lib, *ins)
    assert err == 0
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_matches(got, _ref(*ins), case[5])


def test_bf16_route_follows_the_tma_preconditions(lib):
    """The wrapper loads x, gy, B and C by TMA exactly where every one of
    them meets TMA's preconditions, and the threads' route gives the same
    bits."""
    packed = _inputs(1, 100, 2, 64, 32, torch.bfloat16, True, True, 0.02)
    x, _, _, B, C, _, gy, _ = packed
    assert ssd.tma_route(x, B, C, gy)
    for case in ((2, 48, 4, 8, 4, torch.bfloat16, True, False),
                 (2, 48, 4, 8, 4, torch.bfloat16, False, False)):
        x, _, _, B, C, _, gy, _ = _inputs(*case)
        assert not ssd.tma_route(x, B, C, gy)
    err1, by_tma = _run(lib, *packed, tma=True)
    err2, by_threads = _run(lib, *packed, tma=False)
    assert err1 == err2 == 0
    for name, u, v in zip(NAMES, by_tma, by_threads):
        assert torch.equal(u, v), name
    _assert_matches(by_threads, _ref(*packed), torch.bfloat16)


def test_two_calls_give_the_same_bits(lib):
    ins = _inputs(1, 70, 1, 8, 4, torch.bfloat16, True, True, 0.02, seed=3)
    err1, first = _run(lib, *ins)
    err2, second = _run(lib, *ins)
    assert err1 == err2 == 0
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


def test_bad_dims_are_refused(lib):
    x, dt, A, B, C, D, gy, _ = _inputs(1, 8, 1, 8, 4, torch.float32, False,
                                       False)
    xb = torch.zeros(1, 8, 1, ssd.MAX_P + 1)
    assert _run(lib, xb, dt, A, B, C, D, torch.zeros_like(xb))[0] != 0
    Bb = torch.zeros(1, 8, ssd.MAX_N + 1)
    assert _run(lib, x, dt, A, Bb, Bb, D, gy)[0] != 0


# planted faults: (source line, its faulty replacement, the inputs' dtype:
# float32 runs the CUDA-core kernels, bf16 the tensor-core ones)
PLANTED = {
    "gstate_dropped": (
        "float dH = a.gstate != nullptr ? a.gstate[bh * pn + e] : 0.f;",
        "float dH = 0.f;", torch.float32),
    "carry_into_chunk0_dropped": (
        "dH = fmaf(dH, decay[c], G[k]);",
        "dH = c == 1 ? G[k] : fmaf(dH, decay[c], G[k]);", torch.float32),
    "dH_lo_dropped": (
        "split(H[i], H[i + 1], hi, lo);",
        "split(H[i], H[i + 1], hi, lo);\n        if (rev) lo = 0u;",
        torch.bfloat16),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_fault_fails(libs, lib, fault):
    dtype = PLANTED[fault][2]
    bad = libs[fault]
    ins = _inputs(1, 70, 1, 8, 4, dtype, True, True, 0.02, seed=5)
    want = _ref(*ins)
    err, good = _run(lib, *ins)
    assert err == 0
    _assert_matches(good, want, dtype)
    err, got = _run(bad, *ins)
    assert err == 0
    with pytest.raises(AssertionError):
        _assert_matches(got, want, dtype)
