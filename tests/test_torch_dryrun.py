"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun.run_cell``) on the tiny cells of
``tests/drivers/driver_elastic_dryrun.py`` (``REPRO_DRYRUN_TINY``,
``REPRO_DRYRUN_DEVICES=8``, ``REPRO_DRYRUN_MESH`` 4,2 and 2,2,2), on the
CPU.

Each side runs in a subprocess of its own: the port's cells on a fake
process group of 8 ranks, which becomes that process's default group;
the JAX cells with 8 virtual devices and ``jax.make_mesh`` defaulting to
Auto axes (a runtime default set before ``repro`` is imported, no edit to
``src/repro``: with Explicit axes the reference's dry-run fails, ROADMAP
C0).  Checks:

* ``params``, ``active_params``, ``head_pad``, ``vocab_pad``,
  ``model_flops``, ``tokens`` and ``skipped`` are equal;
* ``argument_size_in_bytes`` differs by exactly the leaves named in
  :func:`_named_difference`: both train steps take this device's block of
  the batch, the port's with int64 tokens and labels where the
  reference's are int32, and the reference's takes an int32 step index;
  the decode step's token block is int64; the prefill's tokens too;
* the per-device FLOPs are within 25 % of the JAX ``hlo.flops_per_device``
  (each ratio printed), also on two cells whose ``model`` axis exceeds
  the KV heads (granite-3-8b's 2 at 2 x 4, granite-20b's 1 at 4 x 2),
  where the reference splits attention by query heads and the port
  repeats each KV head over its query-head group;
* the port's temporaries are at most :data:`TEMP_RATIO` times the JAX
  ``temp_size_in_bytes`` (each ratio printed): attention whole on every
  model rank (the layout before KV-head repetition) takes 2.6 times the
  reference's in the 2 x 4 cell.

It also records granite-3-8b ``train_4k`` at full width on the 16 x 16
production mesh, 256 fake ranks in one process, with its depth cut to 2
layers and one micro-batch of 16 rows a data rank, to keep the test
short (``chip_smoke.py`` records the 40-layer cell on the card's host),
and checks its record.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

#: (REPRO_DRYRUN_MESH, arch, shape, mesh kind): the driver's cells
CELLS = [("4,2", "granite-3-8b", "train_4k", "single"),
         ("2,4", "granite-3-8b", "train_4k", "single"),
         ("4,2", "granite-20b", "train_4k", "single"),
         ("4,2", "mixtral-8x22b", "train_4k", "single"),
         ("4,2", "mamba2-130m", "decode_32k", "single"),
         ("4,2", "whisper-small", "prefill_32k", "single"),
         ("2,2,2", "qwen1.5-0.5b", "train_4k", "multi"),
         ("2,2,2", "granite-20b", "long_500k", "single")]
FLOPS_REL = 0.25
TEMP_RATIO = 2.0
PRODUCTION_MBS = 16
EQUAL = ("params", "active_params", "head_pad", "vocab_pad", "model_flops",
         "tokens", "skipped")


def _run_cells(side: str, out: str) -> None:
    """Every cell of :data:`CELLS` on one side, records to ``out``."""
    os.environ["REPRO_DRYRUN_TINY"] = "1"
    os.environ["REPRO_DRYRUN_DEVICES"] = "8"
    recs = {}
    if side == "jax":
        import functools
        import jax
        from jax.sharding import AxisType
        make = jax.make_mesh
        jax.make_mesh = lambda shape, axes, **kw: make(
            shape, axes, **{"axis_types": (AxisType.Auto,) * len(axes),
                            **kw})
        del functools
        from repro.launch import dryrun
    else:
        from repro_torch.launch import dryrun
    for mesh, arch, shape, kind in CELLS:
        os.environ["REPRO_DRYRUN_MESH"] = mesh
        rec = dryrun.run_cell(arch, shape, kind, Path(out).parent)
        recs[f"{arch}/{shape}/{mesh}"] = {
            k: v for k, v in rec.items()
            if isinstance(v, (int, float, str, dict, list))}
    if side == "torch":
        # the production mesh at full width, its depth cut to 2 layers
        from repro_torch.configs import get_config
        from repro_torch.core.types import SHAPES
        del os.environ["REPRO_DRYRUN_MESH"]
        got = dryrun._record_rank(
            get_config("granite-3-8b").replace(num_layers=2),
            SHAPES["train_4k"], "single", PRODUCTION_MBS, 1, 1, 256, 0)
        got.pop("_mesh")
        st = got.pop("_stats")
        got["families"] = sorted({op.family for op in st.collectives})
        recs["production"] = got
        # the mesh builders over a fake world of 8
        from repro_torch.launch import mesh as lm
        dryrun.fake_world(8, 0)
        os.environ["REPRO_DRYRUN_MESH"] = "2,2,1,2"
        meshes = {"env": lm.mesh_from_env(), "host": lm.make_host_mesh(2, 4)}
        del os.environ["REPRO_DRYRUN_MESH"]
        meshes["unset"] = lm.mesh_from_env()
        recs["meshes"] = {
            k: None if m is None else [list(m.mesh_dim_names),
                                       list(m.mesh.shape)]
            for k, m in meshes.items()}
    Path(out).write_text(json.dumps(recs, default=str))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {side: subprocess.Popen(
        [sys.executable, __file__, side, str(tmp / f"{side}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for side in ("torch", "jax")}
    out = {}
    for side, p in procs.items():
        so, se = p.communicate(timeout=420)
        assert p.returncode == 0, so[-3000:] + se[-6000:]
        out[side] = json.loads((tmp / f"{side}.json").read_text())
    return out["torch"], out["jax"]


def _named_difference(arch: str, shape: str, mesh: str) -> int:
    """Port argument bytes minus the reference's, from the leaves that
    differ (see the module docstring)."""
    from repro_torch.configs import reduce_config, get_config
    from repro_torch.core.types import SHAPES
    cfg = reduce_config(get_config(arch))
    s = SHAPES[shape]
    B, S = min(s.global_batch, 8), min(s.seq_len, 128)
    dp = 1
    for d in (int(x) for x in mesh.split(",")[:-1]):
        dp *= d
    if s.kind == "train":
        # this device's block (int64 tokens, labels; f32 mask) against the
        # same block (int32 tokens, labels; f32 mask) and a step index
        port = B // dp * S * (8 + 8 + 4)
        ref = B // dp * S * (4 + 4 + 4) + 4
        return port - ref
    if s.kind == "decode":
        # the int64 token block against int32; the position counts no
        # bytes on either side (a Python int here, and XLA's memory
        # analysis gives the reference's int32 scalar none in this cell)
        return B // dp * 1 * (8 - 4)
    del cfg
    return B // dp * S * (8 - 4)        # prefill tokens, int64 vs int32


@pytest.mark.parametrize("cell", [f"{a}/{s}/{m}" for m, a, s, _ in CELLS])
def test_dryrun_cell_matches_jax(records, cell):
    port, ref = records
    p, r = port[cell], ref[cell]
    for k in EQUAL:
        assert p.get(k) == r.get(k), (k, p.get(k), r.get(k))
    if "skipped" in r:
        assert "memory" not in p
        return
    arch, shape, mesh = cell.split("/")
    pa = p["memory"]["argument_size_in_bytes"]
    ra = r["memory"]["argument_size_in_bytes"]
    diff = _named_difference(arch, shape, mesh)
    print(f"{cell}: argument bytes port {pa}, JAX {ra}, named difference "
          f"{diff}")
    assert pa - ra == diff, (pa, ra, diff)
    ratio = p["hlo"]["flops_per_device"] / r["hlo"]["flops_per_device"]
    print(f"{cell}: FLOPs per device port {p['hlo']['flops_per_device']:.4g}"
          f", JAX {r['hlo']['flops_per_device']:.4g}, ratio {ratio:.3f}")
    assert abs(ratio - 1) <= FLOPS_REL, ratio
    temp = (p["memory"]["temp_size_in_bytes"]
            / r["memory"]["temp_size_in_bytes"])
    print(f"{cell}: temporaries port {p['memory']['temp_size_in_bytes']}, "
          f"JAX {r['memory']['temp_size_in_bytes']}, ratio {temp:.3f}")
    assert 0 <= temp <= TEMP_RATIO, temp
    assert p["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_mesh_dims_follow_the_reference(monkeypatch):
    """``REPRO_DRYRUN_MESH``'s 2/3 dims name ``(pod,) data, model``, 4/5
    dims ``(pod,) data, pipe, seq, model``; the production mesh is 16 x
    16, 2 x 16 x 16 multi-pod, with pipe/seq carved out of data."""
    from repro_torch.launch.dryrun import _mesh_dims
    monkeypatch.delenv("REPRO_DRYRUN_MESH", raising=False)
    assert _mesh_dims("single", 1, 1) == ((16, 16), ("data", "model"))
    assert _mesh_dims("multi", 1, 1) == ((2, 16, 16),
                                         ("pod", "data", "model"))
    assert _mesh_dims("single", 2, 2) == (
        (4, 2, 2, 16), ("data", "pipe", "seq", "model"))
    for spec, names in (("4,2", ("data", "model")),
                        ("2,2,2", ("pod", "data", "model")),
                        ("2,2,1,2", ("data", "pipe", "seq", "model")),
                        ("2,1,2,1,2", ("pod", "data", "pipe", "seq",
                                       "model"))):
        monkeypatch.setenv("REPRO_DRYRUN_MESH", spec)
        dims, got = _mesh_dims("single", 1, 1)
        assert got == names and dims == tuple(int(x)
                                              for x in spec.split(","))


def test_mesh_builders_over_a_fake_world(records):
    assert records[0]["meshes"] == {
        "env": [["data", "pipe", "seq", "model"], [2, 2, 1, 2]],
        "host": [["data", "model"], [2, 4]], "unset": None}


def test_report_tables_the_records(records, tmp_path):
    from repro_torch.roofline import report
    for i, (cell, rec) in enumerate(records[0].items()):
        if cell not in ("production", "meshes"):
            (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    cells = report.load(tmp_path)
    assert report.summary(cells).startswith("cells: 7 recorded, 1 skipped")
    table = report.roofline_table(cells, "single")
    assert "granite-3-8b | train_4k" in table and "skipped" in table
    assert "qwen1.5-0.5b" in report.roofline_table(cells, "multi")
    assert report.hbm_gib(cells[0]) >= 0


def test_production_mesh_records_in_one_process(records):
    """granite-3-8b ``train_4k`` at full width (2 of its 40 layers) as
    rank 0 of the 16 x 16 production mesh, 256 fake ranks in one process:
    its argument bytes are its blocks', its collectives the sharded
    step's."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.dryrun import _block_shape
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import model_specs
    rec = records[0]["production"]
    cfg = get_config("granite-3-8b").replace(num_layers=2)
    sizes = {"data": 16, "model": 16}
    specs = model_specs(cfg)
    blocks = tree_leaves(shd.param_shardings(specs, sizes,
                                             shd.rules_for(cfg, sizes)))
    want = sum(math.prod(_block_shape(s.shape, b, sizes))
               * s.dtype.itemsize
               for s, b in zip(tree_leaves(specs), blocks))
    parts = rec["memory"]["argument_parts"]
    assert parts["params"] == want, (parts, want)
    # this rank's block: 256 / 16 rows x 4096 of int64 tokens and labels
    # and the f32 mask
    assert parts["batch"] == 256 // 16 * 4096 * (8 + 8 + 4)
    assert set(rec["families"]) == {"all-gather", "all-reduce",
                                    "reduce-scatter"}
    assert rec["hlo"]["flops_per_device"] > 0
    print("production cell (2 layers):", rec["memory"], rec["roofline"],
          f"recorded in {rec['record_s']:.1f} s")


if __name__ == "__main__":
    _run_cells(sys.argv[1], sys.argv[2])
