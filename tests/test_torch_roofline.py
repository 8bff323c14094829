"""The port's roofline layer on the CPU: ``roofline.record`` (a step's
collectives, matmul FLOPs and memory) and ``roofline.analysis`` over it,
with ``tests/test_hlo_analysis.py``'s arithmetic cases that carry over
(the ring wire model, wire bytes by dtype, width selection,
``roofline_terms``' structure), on records the test builds."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.types import H100  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    _ring_wire, collective_families, dot_flops_by_width, dot_flops_matching,
    roofline_terms, total_wire_bytes, wire_bytes_by_dtype)
from repro_torch.roofline.record import (  # noqa: E402
    CollectiveOp, DotOp, StepStats, record)


def _synthetic() -> StepStats:
    """An f32 all-reduce over groups of 4 and a bf16 all-gather over 8,
    1024 elements each (``test_hlo_analysis``'s synthetic program)."""
    return StepStats(collectives=[
        CollectiveOp("all-reduce", "float32", 4, 4096.0,
                     _ring_wire("all-reduce", 4, 4096.0, 4096.0)),
        CollectiveOp("all-gather", "bfloat16", 8, 2048.0,
                     _ring_wire("all-gather", 8, 256.0, 2048.0))])


def test_ring_wire_model():
    assert _ring_wire("all-reduce", 4, 4096, 4096) == \
        pytest.approx(2 * 3 / 4 * 4096)
    assert _ring_wire("all-gather", 8, 256, 2048) == \
        pytest.approx(7 / 8 * 2048)
    assert _ring_wire("all-to-all", 8, 2048, 2048) == \
        pytest.approx(7 / 8 * 2048)
    assert _ring_wire("reduce-scatter", 8, 2048, 256) == \
        pytest.approx(7 / 8 * 2048)
    assert _ring_wire("collective-permute", 8, 2048, 2048) == 2048
    assert _ring_wire("send", 2, 2048, 2048) == 2048
    assert _ring_wire("all-reduce", 1, 4096, 4096) == 0.0


def test_wire_bytes_by_dtype_synthetic():
    rec = _synthetic()
    w = wire_bytes_by_dtype(rec)
    assert w["float32"] == pytest.approx(2 * 3 / 4 * 1024 * 4)
    assert w["bfloat16"] == pytest.approx(7 / 8 * 1024 * 2)
    assert total_wire_bytes(rec) == pytest.approx(w["float32"]
                                                  + w["bfloat16"])
    assert set(collective_families(rec)) == {"all-reduce", "all-gather"}


def test_dot_flops_matching_selects_by_output_width():
    a, b = torch.randn(8, 16), torch.randn(16, 32)
    out, rec = record(lambda a, b: a @ b, a, b)
    assert torch.equal(out, a @ b)
    assert dot_flops_matching(rec, 32) == pytest.approx(2 * 8 * 16 * 32)
    assert dot_flops_matching(rec, 31) == 0.0
    assert dot_flops_by_width(rec) == {32: pytest.approx(2 * 8 * 16 * 32)}


def test_matmul_and_einsum_counted_under_inference_mode():
    """Under inference mode ``matmul`` and ``einsum`` reach the recorder
    whole; they are counted as the decomposed ``mm``/``bmm`` would be."""
    a, b = torch.randn(2, 8, 16), torch.randn(16, 32)
    with torch.inference_mode():
        _, rec = record(lambda a, b: a @ b, a, b)
        _, rec2 = record(lambda a, b: torch.einsum("bsd,de->bse", a, b),
                         a, b)
    want = 2 * 2 * 8 * 16 * 32
    assert rec.flops == pytest.approx(want)
    assert rec2.flops == pytest.approx(want)


def test_recorded_memory_fields():
    """Arguments, a fresh output, an argument written in place (alias) and
    a transient that dies before the end."""
    x = torch.zeros(1024)                       # 4096 bytes

    def step(x):
        t = torch.ones(4096)                    # 16384 bytes, transient
        x.add_(t[:1024])
        del t
        return torch.empty(256), x              # 1024 fresh bytes
    _, rec = record(step, x)
    m = rec.memory
    assert m["argument_size_in_bytes"] == 4096
    assert m["alias_size_in_bytes"] == 4096
    assert m["output_size_in_bytes"] == 4096 + 1024
    # the transient is dead before the output is made
    assert m["peak_bytes"] == 4096 + 16384
    assert (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
            + m["output_size_in_bytes"] - m["alias_size_in_bytes"]
            == m["peak_bytes"])


def test_roofline_terms_structure():
    st = StepStats(flops=989e12, hbm_bytes=3.35e12, collectives=[
        CollectiveOp("all-reduce", "float32", 2, 450e9, 450e9)])
    t = roofline_terms(st, hw=H100)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert t["dominant"] in ("compute", "memory", "collective")
    with pytest.raises(TypeError):
        roofline_terms(st)                      # no default hardware


def test_step_stats_round_trip_through_json():
    rec = _synthetic()
    rec.dots.append(DotOp("aten.mm", 32, 8.0))
    back = StepStats.from_json(rec.to_json())
    assert back.to_json() == rec.to_json()
