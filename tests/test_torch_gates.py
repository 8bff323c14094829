"""The gates (``repro_torch.analysis.hlo_gates``) on the CPU: the
reference's ``resolve``/``validate_gate``/``evaluate`` cases
(``tests/test_analysis.py``) on recorded steps the test builds, and every
gate file under ``src/repro_torch/analysis/gates/`` against the port's
own recorded programs for its regime, with one planted fault per check
kind that must fail.

The programs are recorded in a subprocess (``python
tests/test_torch_gates.py --record OUT.json``), as ranks of a fake world
of 8 (``launch.dryrun.fake_world``: the fake group must be that process's
default group) on meta tensors, at the reduced configs:

* ``regime_pp2`` / ``regime_pp2tp2`` / ``regime_cp2``: the train step of
  granite-3-8b at (dp 2, pp 2), (dp 2, pp 2, tp 2) and (dp 2, cp 2);
* ``regime_compressed`` and ``compress``: the train step at dp 8 with
  ``grad_compress`` none, bf16 and int8, and the isolated reductions
  (``optim.compression.psum`` and the two compressed ones) of an 8192
  float32 gradient over the 8 data ranks;
* ``vp_ce``: the last stage's rank of the (dp 2, pp 4) train step with a
  vocabulary of 2048, vocab-parallel CE on and off;
* ``tp_in_stage``: the (dp 2, pp 2) and (dp 1, pp 2, tp 2) train steps
  with ``d_ff`` 160, rank 0;
* ``cp_overlap`` / ``ulysses_mqa``: ``dist.context.cp_attention``'s
  forward at cp 4 (ulysses, 1 and 4 chunks) and at cp 8 with 8 query and
  4 key-value heads (``ulysses_mqa`` and ``allgather``).
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------- #
# Recording (the subprocess)
# --------------------------------------------------------------------------- #
def _train_program(arch, over, par, seq=32, gb=8, rank=0):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_reduced
    from repro_torch.core.types import ShapeConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.models.common import tree_map
    from repro_torch.models.model import Model, model_specs
    from repro_torch.optim import adamw
    from repro_torch.roofline.record import record
    from repro_torch.train import step as step_mod
    dryrun.fake_world(8, rank)
    cfg = get_reduced(arch).replace(**over)
    mesh = shd.section_mesh(range(par.devices), par)
    sizes = shd.mesh_shape(mesh)
    shape = ShapeConfig("t", "train", seq, gb)
    specs = model_specs(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = Model(cfg, tree_map(lambda s: torch.empty(
            s.shape, dtype=s.dtype, device="meta"), specs))
        step = step_mod.build_train_step(model, par, shape, mesh=mesh)
        params = dryrun.fake_blocks(specs, step.shardings["params"], sizes)
        opt = dryrun.fake_blocks(adamw.state_specs(model.param_shapes()),
                                 step.shardings["opt"], sizes)
        inputs = model.input_specs(shape)
        batch = dryrun.fake_blocks(inputs, step.shardings["batch"], sizes)
        args = (params, opt, batch, 0)
        if par.grad_compress != "none":
            args += (step.shardings["ef_init"](params),)
        _, stats = record(step, *args)
    return stats


def _reduce_program(method):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.types import ParallelConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.optim import compression as gcomp
    from repro_torch.roofline.record import record
    dryrun.fake_world(8, 0)
    mesh = shd.section_mesh(range(8), ParallelConfig(dp=8))
    fn = {"none": gcomp.psum, "bf16": gcomp.compressed_psum_bf16,
          "int8": gcomp.compressed_psum_int8}[method]
    with FakeTensorMode(allow_non_fake_inputs=True):
        g = torch.empty(8192, dtype=torch.float32, device="meta")
        _, stats = record(fn, g, mesh.get_group("data"))
    return stats


def _cp_program(H, KV, cp, mode, chunks):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.types import ParallelConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.context import cp_attention
    from repro_torch.launch import dryrun
    from repro_torch.roofline.record import record
    dryrun.fake_world(8, 0)
    mesh = shd.section_mesh(range(cp), ParallelConfig(cp=cp))
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        q = torch.empty((2, 16, H, 32), device="meta")
        k = torch.empty((2, 16, KV, 32), device="meta")
        _, stats = record(cp_attention, q, k, k, mesh, mode=mode,
                          overlap_chunks=chunks)
    return stats


def record_programs() -> dict:
    from repro_torch.core.types import ParallelConfig as PC
    g = "granite-3-8b"
    vocab = dict(vocab_size=2048)
    progs = {
        "pp2": _train_program(g, {}, PC(dp=2, pp=2)),
        "pp2tp2": _train_program(g, {}, PC(dp=2, pp=2, tp=2)),
        "cp2": _train_program(g, {}, PC(dp=2, cp=2)),
        "step_none": _train_program(g, {}, PC(dp=8)),
        "step_bf16": _train_program(g, {}, PC(dp=8, grad_compress="bf16")),
        "step_int8": _train_program(g, {}, PC(dp=8, grad_compress="int8")),
        "red_none": _reduce_program("none"),
        "red_bf16": _reduce_program("bf16"),
        "red_int8": _reduce_program("int8"),
        # the last stage: rank (data 0, pipe 3) of the (2, 4, 1, 1) mesh
        "vp": _train_program(g, dict(vocab, num_layers=4), PC(dp=2, pp=4),
                             rank=3),
        "tp1": _train_program(g, dict(d_ff=160), PC(dp=2, pp=2)),
        "tp2": _train_program(g, dict(d_ff=160), PC(dp=1, pp=2, tp=2)),
        "mono": _cp_program(8, 8, 4, "ulysses", 1),
        "overlap": _cp_program(8, 8, 4, "ulysses", 4),
        "mqa": _cp_program(8, 4, 8, "ulysses_mqa", 1),
        "allgather": _cp_program(8, 4, 8, "allgather", 1),
    }
    # the masked baseline: a padded vocabulary the 4 stages do not divide
    # (2048 + 2), so the last stage scores it whole
    progs["masked"] = _train_program(
        g, dict(vocab, num_layers=4, vocab_pad=2), PC(dp=2, pp=4), rank=3)
    progs["compressed"] = progs["step_int8"]
    return {k: v.to_json() for k, v in progs.items()}


# --------------------------------------------------------------------------- #
# The tests
# --------------------------------------------------------------------------- #
#: gate file -> {gate program: recorded program}
BINDINGS = {
    "regime_pp2": {"step": "pp2"},
    "regime_pp2tp2": {"step": "pp2tp2"},
    "regime_cp2": {"step": "cp2"},
    "regime_compressed": {"step": "compressed"},
    "compress": {k: k for k in ("red_none", "red_bf16", "red_int8",
                                "step_none", "step_bf16", "step_int8")},
    "vp_ce": {"masked": "masked", "vp": "vp"},
    "tp_in_stage": {"tp1": "tp1", "tp2": "tp2"},
    "cp_overlap": {"mono": "mono", "overlap": "overlap"},
    "ulysses_mqa": {"mqa": "mqa", "allgather": "allgather"},
}


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    from repro_torch.roofline.record import StepStats
    out = tmp_path_factory.mktemp("gates") / "programs.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, "--record", str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return {k: StepStats.from_json(v)
            for k, v in json.loads(out.read_text()).items()}


def _bound(name, programs):
    return {p: programs[r] for p, r in BINDINGS[name].items()}


def test_every_gate_file_is_bound():
    from repro_torch.analysis import hlo_gates
    assert {p.stem for p in hlo_gates.list_gates()} == set(BINDINGS)


@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_gate_passes_on_its_regimes_recorded_step(programs, name):
    from repro_torch.analysis import hlo_gates
    rep, measured = hlo_gates.evaluate_file(
        hlo_gates.GATES_DIR / f"{name}.json", _bound(name, programs))
    print(rep.render())
    assert rep.ok, rep.render()
    assert measured


def _with_op(rec, **kw):
    from repro_torch.roofline.record import CollectiveOp
    rec = copy.deepcopy(rec)
    rec.collectives.append(CollectiveOp(**kw))
    return rec


#: check kind -> (gate, {gate program: recorded program or a planted
#: record}, the check id that must fail)
def _planted(programs):
    p = programs
    return {
        "collectives_subset": ("regime_pp2", {"step": _with_op(
            p["pp2"], family="all-to-all", dtype="float32", group_size=2,
            payload_bytes=4096.0, wire_bytes=2048.0)}, "families"),
        "wire_dtype": ("regime_compressed", {"step": p["step_none"]},
                       "ships_int8"),
        "family_dtype_wire": ("regime_compressed", {"step": _with_op(
            p["compressed"], family="all-reduce", dtype="float32",
            group_size=8, payload_bytes=1e6, wire_bytes=1.75e6)},
            "f32_allreduce_residue"),
        "dot_flops": ("vp_ce", {"masked": p["masked"], "vp": p["masked"]},
                      "no_full_vocab_left"),
        "dot_flops_ratio": ("tp_in_stage", {"tp1": p["tp1"],
                                            "tp2": p["tp1"]}, "reduction"),
        "wire_total_ratio": ("compress", dict(
            _bound("compress", p), red_bf16=p["red_none"]),
            "bf16_over_fp32"),
        "collective_count": ("cp_overlap", {"mono": p["mono"],
                                            "overlap": p["mono"]},
                             "overlap_a2a_count"),
        "collective_payload_ratio": ("cp_overlap", {
            "mono": p["mono"], "overlap": p["mono"]},
            "min_payload_div_chunks"),
    }


@pytest.mark.parametrize("kind", ["collectives_subset", "wire_dtype",
                                  "family_dtype_wire", "dot_flops",
                                  "dot_flops_ratio", "wire_total_ratio",
                                  "collective_count",
                                  "collective_payload_ratio"])
def test_planted_fault_fails_its_check(programs, kind):
    from repro_torch.analysis import hlo_gates
    gate, progs, check_id = _planted(programs)[kind]
    rep, _ = hlo_gates.evaluate_file(hlo_gates.GATES_DIR / f"{gate}.json",
                                     progs)
    failed = {f.subject.split("/")[-1] for f in rep.errors}
    assert check_id in failed, rep.render()


# --------------------------------------------------------------------------- #
# tests/test_analysis.py's engine cases, on records built here
# --------------------------------------------------------------------------- #
def test_resolve_expressions():
    from repro_torch.analysis import hlo_gates
    syms = {"pp": 4, "vocab": 1024, "gb": 8}
    assert hlo_gates.resolve(7, syms) == 7.0
    assert hlo_gates.resolve("vocab/pp", syms) == 256.0
    assert hlo_gates.resolve("0.05*pp", syms) == pytest.approx(0.2)
    assert hlo_gates.resolve("vocab/pp/2", syms) == 128.0
    with pytest.raises(ValueError, match="unknown symbol"):
        hlo_gates.resolve("nope*2", syms)
    with pytest.raises(ValueError, match="unresolvable"):
        hlo_gates.resolve("a + b", syms)


def test_validate_gate_schema_errors():
    from repro_torch.analysis import hlo_gates
    base = {"name": "g", "description": "d", "programs": ["p"],
            "checks": []}
    with pytest.raises(ValueError, match="missing 'name'"):
        hlo_gates.validate_gate({k: v for k, v in base.items()
                                 if k != "name"})
    with pytest.raises(ValueError, match="unknown kind"):
        hlo_gates.validate_gate({**base, "checks": [{"kind": "bogus"}]})
    with pytest.raises(ValueError, match="not declared"):
        hlo_gates.validate_gate(
            {**base, "checks": [{"kind": "wire_dtype", "program": "q",
                                 "dtype": "float32", "op": "<=",
                                 "value": 1}]})
    with pytest.raises(ValueError, match="op"):
        hlo_gates.validate_gate(
            {**base, "checks": [{"kind": "wire_dtype", "program": "p",
                                 "dtype": "float32", "op": "~",
                                 "value": 1}]})


def _gate(tmp_path, raw):
    from repro_torch.analysis import hlo_gates
    f = tmp_path / "g.json"
    f.write_text(json.dumps(raw))
    return hlo_gates.load_gate(f)


def _synth():
    """An f32 all-reduce over 4 and a bf16 all-gather over 8, 1024
    elements each."""
    from repro_torch.roofline.analysis import _ring_wire
    from repro_torch.roofline.record import CollectiveOp, StepStats
    return StepStats(collectives=[
        CollectiveOp("all-reduce", "float32", 4, 4096.0,
                     _ring_wire("all-reduce", 4, 4096.0, 4096.0)),
        CollectiveOp("all-gather", "bfloat16", 8, 2048.0,
                     _ring_wire("all-gather", 8, 256.0, 2048.0))])


def test_gate_dot_flops_and_ratio(tmp_path):
    import torch
    from repro_torch.analysis import hlo_gates
    from repro_torch.roofline.record import record
    a = torch.randn(8, 16)
    _, full = record(lambda a, b: a @ b, a, torch.randn(16, 32))
    _, shard = record(lambda a, b: a @ b, a, torch.randn(16, 8))
    gate = _gate(tmp_path, {
        "name": "toy", "description": "d",
        "symbols": {"w": 32, "shards": 4},
        "programs": ["full", "shard"],
        "checks": [
            {"kind": "dot_flops", "id": "full_present", "program": "full",
             "width": "w", "op": ">", "value": 0},
            {"kind": "dot_flops", "id": "no_full_in_shard",
             "program": "shard", "width": "w", "op": "==", "value": 0},
            {"kind": "dot_flops_ratio", "id": "reduction",
             "num_program": "full", "num_width": "w",
             "den_program": "shard", "den_width": "w/shards",
             "target": "shards", "rtol": 0.05},
        ]})
    rep, measured = hlo_gates.evaluate(gate, {"full": full, "shard": shard})
    assert rep.ok, rep.render()
    assert measured["full_present"] == pytest.approx(2 * 8 * 16 * 32)
    assert measured["reduction"] == pytest.approx(4.0)
    rep2, _ = hlo_gates.evaluate(gate, {"full": full, "shard": shard},
                                 symbols={"w": 8})
    bad = [f for f in rep2.errors if f.check == "hlo.dot_flops"]
    assert bad and "width histogram" in bad[0].message


def test_gate_wire_dtype_family_and_subset(tmp_path):
    from repro_torch.analysis import hlo_gates
    gate = _gate(tmp_path, {
        "name": "wires", "description": "d", "symbols": {},
        "programs": ["step"],
        "checks": [
            {"kind": "wire_dtype", "id": "bf16", "program": "step",
             "dtype": "bfloat16", "op": ">", "value": 0},
            {"kind": "wire_dtype", "id": "no_int8", "program": "step",
             "dtype": "int8", "op": "==", "value": 0},
            {"kind": "family_dtype_wire", "id": "f32_ar",
             "program": "step", "family": "all-reduce", "dtype": "float32",
             "op": "<=", "value": 6144},
            {"kind": "collectives_subset", "id": "fams",
             "program": "step", "allowed": ["all-reduce"]},
        ]})
    rep, measured = hlo_gates.evaluate(gate, {"step": _synth()})
    assert measured["bf16"] == pytest.approx(7 / 8 * 1024 * 2)
    assert measured["f32_ar"] == pytest.approx(2 * 3 / 4 * 1024 * 4)
    sub = [f for f in rep.errors if f.check == "hlo.collectives_subset"]
    assert sub and "all-gather" in sub[0].message
    assert "silent replication" in sub[0].message


def test_gate_wire_total_ratio_and_missing_program(tmp_path):
    from repro_torch.analysis import hlo_gates
    gate = _gate(tmp_path, {
        "name": "r", "description": "d", "symbols": {},
        "programs": ["a", "b"],
        "checks": [
            {"kind": "wire_total_ratio", "id": "ratio",
             "num_program": "a", "den_program": "b",
             "op": "<=", "value": 1.0},
        ]})
    rep, measured = hlo_gates.evaluate(gate, {"a": _synth(), "b": _synth()})
    assert rep.ok and measured["ratio"] == pytest.approx(1.0)
    rep2, _ = hlo_gates.evaluate(gate, {"a": _synth()})
    assert [f.check for f in rep2.errors] == ["hlo.missing-program"]


def test_committed_gate_files_all_load_and_the_pass_is_registered():
    from repro_torch.analysis import PASSES, hlo_gates
    for p in hlo_gates.list_gates():
        gate = hlo_gates.load_gate(p)      # schema-validates
        assert gate.checks, p
        assert "reference" in gate.description, p
    assert PASSES["hlo"] is hlo_gates.evaluate


if __name__ == "__main__":
    assert sys.argv[1] == "--record", sys.argv
    Path(sys.argv[2]).write_text(json.dumps(record_programs()))
