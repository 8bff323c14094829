"""The port's gradient compression (``repro_torch.optim.compression``)
against the JAX package's.

1. The six cases of ``tests/test_compression.py`` that are not about
   buffer donation, each on the same seeded input through the JAX function
   (in a ``shard_map`` over a one-device ``data`` axis) and the port's (on
   a one-rank gloo group).  On one member the reference skips the
   collectives and the port runs them: the bf16 results are equal bit for
   bit, the int8 ones within a float32 rounding of the scale.
2. Eight gloo ranks (``tests/torch_drivers/driver_compression.py``) against
   the reference's 8-way ``shard_map`` on the same [8, 5000] input, run by
   this file as ``python tests/test_torch_compression.py --jax-oracle
   out.npz`` with 8 virtual devices: ``compressed_psum_{bf16,int8}`` inside
   ``tests/drivers/driver_compression.py``'s analytic bounds and within one
   phase-2 quantization step (int8) or one bf16 ulp (bf16) of the
   reference's result; error feedback over 20 steps within that driver's
   drift bound; the wire counters' payload against ``wire_bytes``.
"""
import os
import sys

if __name__ == "__main__":
    # the JAX oracle: 8 virtual CPU devices, set before JAX is imported
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType, PartitionSpec as JP  # noqa: E402

from repro.dist import sharding as jshd  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DRIVER = ROOT / "tests" / "torch_drivers" / "driver_compression.py"
DP, N, M = 8, 5000, 64
WIRE = {"a": (16, 8), "b": (100,)}


def _inputs():
    rng = np.random.default_rng(0)
    return {"xs": rng.normal(size=(DP, N)).astype(np.float32),
            "g_const": rng.normal(size=(DP, M)).astype(np.float32),
            **{f"wire/{k}": rng.normal(size=s).astype(np.float32)
               for k, s in WIRE.items()}}


# --------------------------------------------------------------------------- #
# 1. single-member cases against the JAX functions
# --------------------------------------------------------------------------- #
def _run_axis(fn, *args):
    """fn(*args) inside a shard_map over a one-device 'data' axis."""
    mesh = jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    return jshd.shard_map(fn, mesh, tuple(JP() for _ in args), JP())(*args)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo process group in this process, destroyed after."""
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_compressed_psum_n1_is_local_roundtrip(group):
    x = np.linspace(-3.0, 3.0, 101, dtype=np.float32)
    jbf = _run_axis(lambda v: jcomp.compressed_psum_bf16(v, "data"),
                    jnp.asarray(x))
    bf = tcomp.compressed_psum_bf16(_t(x))
    np.testing.assert_array_equal(bf.numpy(), np.asarray(jbf))
    np.testing.assert_array_equal(bf.numpy(), _t(x).bfloat16().float())
    jq = _run_axis(lambda v: jcomp.compressed_psum_int8(v, "data"),
                   jnp.asarray(x))
    q = tcomp.compressed_psum_int8(_t(x))
    scale = float(np.abs(x).max()) / 127.0
    assert np.max(np.abs(q.numpy() - x)) <= 0.5 * scale + 1e-7
    # the requantized scale is the reference's within one float32 rounding
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=2e-7,
                               atol=0)


def test_int8_quant_roundtrip_error_bound():
    x = np.random.default_rng(0).normal(size=(257,)).astype(np.float32)
    jq, jscale = jcomp._quant_int8(jnp.asarray(x))
    q, scale = tcomp._quant_int8(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    err = np.abs(tcomp._dequant_int8(q, scale).numpy() - x)
    assert err.max() <= 0.5 * float(scale) + 1e-7


def test_ef_residual_is_exact_quant_error_and_reenters(group):
    g = np.random.default_rng(1).normal(size=(33,)).astype(np.float32)

    def jstep(grads, ef):
        return jcomp.ef_compress_tree(grads, ef, "data", "int8")

    jg = {"w": jnp.asarray(g)}
    jred, jef1 = _run_axis(jstep, jg, jcomp.ef_init(jg))
    tg = {"w": _t(g)}
    red, ef1 = tcomp.ef_compress_tree(tg, tcomp.ef_init(tg), None, "int8")
    recon = red["w"].numpy() + ef1.residual["w"].numpy()
    np.testing.assert_allclose(recon, g, atol=1e-6)
    assert float(ef1.residual["w"].abs().max()) > 0
    np.testing.assert_array_equal(ef1.residual["w"].numpy(),
                                  np.asarray(jef1.residual["w"]))
    np.testing.assert_allclose(red["w"].numpy(), np.asarray(jred["w"]),
                               rtol=2e-7, atol=0)
    # the residual enters the next step's gradient before compression
    z = {"w": torch.zeros(33)}
    red2, _ = tcomp.ef_compress_tree(z, ef1, None, "int8")
    jred2, _ = _run_axis(jstep, {"w": jnp.zeros(33)}, jef1)
    scale2 = float(ef1.residual["w"].abs().max()) / 127.0
    assert np.max(np.abs(red2["w"].numpy() - ef1.residual["w"].numpy())) \
        <= 0.5 * scale2 + 1e-7
    np.testing.assert_allclose(red2["w"].numpy(), np.asarray(jred2["w"]),
                               rtol=2e-7, atol=1e-12)


def test_ef_none_method_is_exact_with_zero_residual(group):
    g = {"w": torch.arange(8, dtype=torch.float32)}
    red, ef = tcomp.ef_compress_tree(g, tcomp.ef_init(g), None, "none")
    jg = {"w": jnp.arange(8, dtype=jnp.float32)}
    jred, _ = _run_axis(lambda gr, e: jcomp.ef_compress_tree(
        gr, e, "data", "none"), jg, jcomp.ef_init(jg))
    np.testing.assert_array_equal(red["w"].numpy(), np.asarray(jred["w"]))
    assert float(ef.residual["w"].abs().max()) == 0.0


def test_unknown_method_rejected(group):
    g = {"w": torch.zeros(4)}
    with pytest.raises(ValueError, match="fp4"):
        tcomp.ef_compress_tree(g, tcomp.ef_init(g), None, "fp4")


def test_wire_bytes_payload_ratios():
    tree = {"a": torch.zeros(16, 8), "b": torch.zeros(100)}
    jtree = {"a": jnp.zeros((16, 8)), "b": jnp.zeros((100,))}
    for method, per in (("none", 4), ("bf16", 2), ("int8", 1)):
        assert tcomp.wire_bytes(tree, method) == \
            jcomp.wire_bytes(jtree, method) == per * (16 * 8 + 100)


# --------------------------------------------------------------------------- #
# 2. eight ranks against the reference's 8-way shard_map
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """(driver_compression.py's output, the JAX oracle's), computed at
    once."""
    tmp = tmp_path_factory.mktemp("comp")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = subprocess.Popen(
        [sys.executable, str(DRIVER), str(DP), str(tmp / "in.npz"),
         str(tmp / "port.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        ref = subprocess.run(
            [sys.executable, __file__, "--jax-oracle", str(tmp / "in.npz"),
             str(tmp / "jax.npz")], capture_output=True, text=True,
            env=dict(env, JAX_PLATFORMS="cpu"), timeout=600)
        out, err = port.communicate(timeout=600)
    finally:
        port.kill()
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert "DRIVER_OK compression" in out, out + err
    return np.load(tmp / "port.npz"), np.load(tmp / "jax.npz")


def _bounds():
    xs = _inputs()["xs"]
    exact = xs.sum(axis=0)
    scales = np.abs(xs).max(axis=1) / 127.0
    return xs, exact, scales


def test_psum_bf16_within_bounds_and_one_ulp_of_the_reference(eight):
    port, ref = eight
    xs, exact, _ = _bounds()
    bf = port["bf16"]
    # tests/drivers/driver_compression.py's bound: each term and the
    # reduced value round to bf16 once
    bound = (2.0 ** -8) * np.abs(xs).sum(axis=0) + (2.0 ** -8) * np.abs(
        exact)
    assert (np.abs(bf - exact) <= bound * 1.05 + 1e-6).all()
    assert np.abs(bf - exact).max() > 0
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref["bf16"]),
                                              1e-30))) - 7)
    assert (np.abs(bf - ref["bf16"]) <= ulp).all(), \
        np.abs(bf - ref["bf16"]).max()
    np.testing.assert_allclose(port["exact"], exact, rtol=1e-5, atol=1e-5)


def test_psum_int8_within_bounds_and_one_step_of_the_reference(eight):
    port, ref = eight
    _, exact, scales = _bounds()
    q8 = port["int8"]
    step2 = np.abs(exact).max() / 127.0 + scales.sum() / 127.0
    bound = 0.5 * scales.sum() + 0.5 * step2
    assert np.abs(q8 - exact).max() <= bound * 1.05 + 1e-6
    assert np.abs(q8 - ref["int8"]).max() <= step2, \
        np.abs(q8 - ref["int8"]).max()


def test_error_feedback_drift_over_20_steps(eight):
    port, ref = eight
    g = _inputs()["g_const"].astype(np.float64)
    target = g.mean(axis=0) * 20
    bound = 2.0 * np.abs(g).max() / 127.0 * DP
    assert np.abs(port["ef_emitted"] - target).max() <= bound
    assert np.abs(ref["ef_emitted"] - target).max() <= bound
    assert float(port["ef_residual_max"][0]) > 0


def test_wire_counters_carry_the_compressed_payload(eight):
    port, _ = eight
    numel = sum(int(np.prod(s)) for s in WIRE.values())
    padded = sum(-(-int(np.prod(s)) // DP) * DP for s in WIRE.values())
    assert int(port["wire/payload_f32"]) == 4 * numel
    want = {"none": {"psum.float32": 4 * numel},
            "bf16": {"bf16.bfloat16": 2 * padded},
            "int8": {"int8.int8": padded,
                     "int8.float32": 2 * 4 * len(WIRE)}}
    for method, counts in want.items():
        for name in tcomp.wire_counts():
            assert int(port[f"wire/{method}/{name}"]) == counts.get(name, 0), \
                (method, name)


# --------------------------------------------------------------------------- #
# the JAX oracle (run as a script)
# --------------------------------------------------------------------------- #
def _jax_oracle(in_path, out_path):
    arrays = np.load(in_path)
    mesh8 = jax.make_mesh((DP,), ("data",), axis_types=(AxisType.Auto,))

    def reduce_with(fn):
        return jax.jit(jshd.shard_map(lambda xs: fn(xs[0], "data"), mesh8,
                                      (JP("data"),), JP()))

    xs = jnp.asarray(arrays["xs"])
    out = {"bf16": np.asarray(reduce_with(jcomp.compressed_psum_bf16)(xs)),
           "int8": np.asarray(reduce_with(jcomp.compressed_psum_int8)(xs))}

    def body(g, ef):
        red, new_ef = jcomp.ef_compress_tree(
            {"w": g["w"][0]}, jcomp.ErrorFeedback({"w": ef["w"][0]}),
            "data", "int8")
        return red, {"w": new_ef.residual["w"][None]}

    ef_step = jax.jit(jshd.shard_map(body, mesh8, (JP("data"), JP("data")),
                                     (JP(), JP("data"))))
    g = {"w": jnp.asarray(arrays["g_const"])}
    ef = {"w": jnp.zeros_like(g["w"])}
    emitted = np.zeros(M, np.float64)
    for _ in range(20):
        red, ef = ef_step(g, ef)
        emitted += np.asarray(red["w"], np.float64)
    out["ef_emitted"] = emitted
    np.savez(out_path, **out)


if __name__ == "__main__":
    assert sys.argv[1] == "--jax-oracle", sys.argv
    _jax_oracle(sys.argv[2], sys.argv[3])
