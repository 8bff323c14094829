"""The port's two-stage section planner (``repro_torch.core.planner``, paper
§3.2) and the cost model's ``fits``, on the CPU, against the JAX package.

1. Every case of ``tests/test_planner.py`` on the port, given a
   ``HardwareSpec`` built from ``repro.core.types.V5E``'s numbers (the
   reference's default device).
2. The port's plans equal the reference's field by field under those
   numbers: the candidates, ``fits``, ``plan_critical``,
   ``plan_auxiliary`` (with and without a GPU cap) and ``plan`` for the
   compound configurations at the reference tests' budgets.
3. On the ``H100``, every section of each plan fits the card and eq. 2
   holds on every edge (DP^producer x fanout = DP^consumer).
4. No planner or cost-model function has a default ``hw``.
"""
import dataclasses
import inspect

import pytest

from repro.configs import compound as jcompound
from repro.configs import get_config as jget_config
from repro.core import cost_model as jcmdl
from repro.core import planner as jplanner
from repro.core.graph import build_distill_graph as jdistill_graph
from repro.core.types import V5E
from repro_torch.configs import compound as tcompound
from repro_torch.configs import get_config
from repro_torch.core import cost_model as cmdl
from repro_torch.core import planner
from repro_torch.core.graph import build_distill_graph, build_vlm_graph
from repro_torch.core.types import (H100, HardwareSpec, ParallelConfig,
                                    SectionConfig)
from repro_torch.models.vlm import vit_config

# the reference's default device, as the port's HardwareSpec
TPU = HardwareSpec(name=V5E.name, peak_flops_bf16=V5E.peak_flops_bf16,
                   hbm_bandwidth=V5E.hbm_bandwidth,
                   ici_bandwidth=V5E.ici_bandwidth, hbm_bytes=V5E.hbm_bytes)
# the reference tests' budgets (tests/test_planner.py)
BUDGET = dict(critical_gpus=256, seq_len=4096, global_batch=256)
GRAPHS = [("self_distill_compound", None), ("distill_compound", None),
          ("vlm_compound", {"vit": 0.3})]


# --------------------------------------------------------------------- #
# 1. tests/test_planner.py on the port
# --------------------------------------------------------------------- #
def test_candidates_respect_divisibility():
    cfg = get_config("granite-3-8b")       # 32 heads, 40 layers
    for c in planner.candidate_parallelisms(cfg, 64):
        assert cfg.num_heads % c.tp == 0
        assert cfg.num_layers % c.pp == 0
        assert c.dp * c.tp * c.pp * c.cp == 64


def test_fig9_teacher_mbs_calibration():
    """Paper Fig. 9: teacher mbs 1→4 gives ≈2.6× throughput at ~flat
    memory."""
    cfg = get_config("granite-3-8b")
    p1 = ParallelConfig(dp=1, tp=8, mbs=1)
    p4 = ParallelConfig(dp=1, tp=8, mbs=4)
    t1 = cmdl.microbatch_time(cfg, p1, 4096, forward_only=True, hw=TPU)
    t4 = cmdl.microbatch_time(cfg, p4, 4096, forward_only=True, hw=TPU)
    thr_ratio = (4 / t4) / (1 / t1)
    assert 2.3 < thr_ratio < 2.9, thr_ratio
    m1 = cmdl.memory_per_gpu(cfg, p1, 4096, trainable=False)
    m4 = cmdl.memory_per_gpu(cfg, p4, 4096, trainable=False)
    assert m4 / m1 < 1.3          # "peak memory remains nearly flat"


def test_memory_model_orders():
    cfg = get_config("granite-3-8b")
    train = cmdl.memory_per_gpu(cfg, ParallelConfig(tp=8), 4096,
                                trainable=True)
    frozen = cmdl.memory_per_gpu(cfg, ParallelConfig(tp=8), 4096,
                                 trainable=False)
    assert frozen < train / 2      # teacher ≪ student memory (§2.2)


def test_stage1_fits_memory():
    sec_plan = planner.plan_critical(
        SectionConfig("s", get_config("granite-3-8b"), ParallelConfig(),
                      critical=True), 256, 4096, 256, hw=TPU)
    assert sec_plan.mem_per_gpu <= TPU.hbm_bytes * 0.9
    assert 256 % sec_plan.parallel.dp == 0


def test_self_distill_plan_overlaps():
    """Self-distillation: frozen same-arch teacher overlaps with fewer
    GPUs (paper §2.2)."""
    cfg = get_config("granite-3-8b")
    p = planner.plan(build_distill_graph(cfg, cfg), **BUDGET, hw=TPU)
    t = p.sections["teacher"]
    s = p.sections["student"]
    assert not t.stalls_critical
    assert t.n_gpus < s.n_gpus            # fewer resources, still overlaps
    assert t.parallel.dp * t.fanout == s.parallel.dp   # eq. (1)
    assert t.t_iter <= s.t_iter + 1e-9


def test_vlm_plan_small_vit_overlaps():
    g = build_vlm_graph(vit_config(out_dim=5120), get_config("qwen2.5-32b"))
    p = planner.plan(g, **BUDGET, activation_rates={"vit": 0.3}, hw=TPU)
    v = p.sections["vit"]
    assert not v.stalls_critical
    assert v.n_gpus <= 32                  # ≈ the paper's ~12.5% envelope
    assert v.parallel.dp * v.fanout == p.sections["llm"].parallel.dp


def test_infeasible_overlap_flags_stall():
    """When the GPU cap genuinely cannot hide the teacher, the planner
    must say so rather than pretend (best-effort plan + stall flag)."""
    g = build_distill_graph(get_config("qwen2.5-32b"),
                            get_config("granite-3-8b"))
    crit = planner.plan_critical(g.sections["student"], 128, 4096, 256,
                                 hw=TPU)
    aux = planner.plan_auxiliary(g.sections["teacher"], crit, 4096, 256,
                                 is_producer=True, gpu_cap=16, hw=TPU)
    assert aux.stalls_critical
    assert aux.n_gpus <= 16
    # and with a generous cap the same teacher overlaps cleanly
    aux2 = planner.plan_auxiliary(g.sections["teacher"], crit, 4096, 256,
                                  is_producer=True, gpu_cap=512, hw=TPU)
    assert not aux2.stalls_critical


def test_flops_per_token_tracks_6nd():
    cfg = get_config("granite-3-8b")
    f = cmdl.flops_per_token_fwd(cfg, 4096)
    assert f > 2 * cfg.active_params()            # fwd ≥ 2N
    assert f < 2 * cfg.active_params() * 1.5      # attention overhead < 50%


# --------------------------------------------------------------------- #
# 2. field by field against the reference
# --------------------------------------------------------------------- #
def _fields(sp) -> dict:
    out = dataclasses.asdict(sp)
    out["parallel"] = {k: out["parallel"][k]
                       for k in ("dp", "tp", "pp", "cp", "mbs")}
    return out


def _same_plan(tp, jp):
    assert tp.total_gpus == jp.total_gpus
    assert tp.iter_time == jp.iter_time
    assert list(tp.sections) == list(jp.sections)
    for name in jp.sections:
        assert _fields(tp.sections[name]) == _fields(jp.sections[name]), name
    assert tp.summary() == jp.summary()


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen2.5-32b",
                                  "mamba2-130m", "mixtral-8x22b"])
@pytest.mark.parametrize("n", [1, 8, 64])
def test_candidates_and_fits_match_the_reference(name, n):
    cands = planner.candidate_parallelisms(get_config(name), n)
    jcands = jplanner.candidate_parallelisms(jget_config(name), n)
    assert [(c.dp, c.tp, c.pp, c.cp, c.mbs) for c in cands] == [
        (c.dp, c.tp, c.pp, c.cp, c.mbs) for c in jcands]
    for c in cands[::7]:
        for trainable in (True, False):
            assert cmdl.fits(get_config(name), c, 4096, trainable=trainable,
                             hw=TPU) == jcmdl.fits(
                jget_config(name), jcands[cands.index(c)], 4096,
                trainable=trainable)


@pytest.mark.parametrize("name,rates", GRAPHS)
def test_plans_match_the_reference_field_by_field(name, rates):
    _same_plan(planner.plan(tcompound.COMPOUND[name](), **BUDGET,
                            activation_rates=rates, hw=TPU),
               jplanner.plan(jcompound.COMPOUND[name](), **BUDGET,
                             activation_rates=rates))


@pytest.mark.parametrize("gpu_cap", [16, None])
def test_stage2_matches_the_reference(gpu_cap):
    g = build_distill_graph(get_config("qwen2.5-32b"),
                            get_config("granite-3-8b"))
    jg = jdistill_graph(jget_config("qwen2.5-32b"),
                        jget_config("granite-3-8b"))
    crit = planner.plan_critical(g.sections["student"], 128, 4096, 256,
                                 hw=TPU)
    jcrit = jplanner.plan_critical(jg.sections["student"], 128, 4096, 256)
    assert _fields(crit) == _fields(jcrit)
    aux = planner.plan_auxiliary(g.sections["teacher"], crit, 4096, 256,
                                 is_producer=True, gpu_cap=gpu_cap, hw=TPU)
    jaux = jplanner.plan_auxiliary(jg.sections["teacher"], jcrit, 4096, 256,
                                   is_producer=True, gpu_cap=gpu_cap)
    assert _fields(aux) == _fields(jaux)


# --------------------------------------------------------------------- #
# 3. on the H100
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,rates", GRAPHS)
def test_h100_plans_hold_eq2(name, rates):
    g = tcompound.COMPOUND[name]()
    p = planner.plan(g, **BUDGET, activation_rates=rates, hw=H100)
    for sec, sp in p.sections.items():
        cfg = g.sections[sec]
        assert sp.mem_per_gpu <= H100.hbm_bytes * 0.9
        assert cmdl.fits(cfg.arch, sp.parallel,
                         int(BUDGET["seq_len"] * cfg.seq_scale),
                         trainable=cfg.trainable, hw=H100)
        assert sp.n_gpus == sp.parallel.devices
    assert g.edges
    for e in g.edges:
        src, dst = p.sections[e.src], p.sections[e.dst]
        assert src.parallel.dp * src.fanout == dst.parallel.dp
    assert p.total_gpus == sum(sp.n_gpus for sp in p.sections.values())
    # the H100's larger memory and rate change the plan from the TPU's
    assert p.summary() != planner.plan(g, **BUDGET, activation_rates=rates,
                                       hw=TPU).summary()


def test_one_card_plan_for_the_distill_runtime_batch():
    cfg = get_config("qwen1.5-0.5b")
    one = planner.plan_critical(
        SectionConfig("student", cfg, ParallelConfig(), critical=True), 1,
        2048, 4, hw=H100)
    assert one.parallel.devices == 1 and one.n_gpus == 1
    assert one.parallel.mbs == 4         # the whole batch, one microbatch
    assert 0 < one.mem_per_gpu <= H100.hbm_bytes * 0.9
    with pytest.raises(ValueError, match="no feasible config"):
        planner.plan_critical(
            SectionConfig("s", get_config("qwen2.5-32b"), ParallelConfig(),
                          critical=True), 1, 4096, 256, hw=H100)


# --------------------------------------------------------------------- #
# 4. no default device
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fn", [planner.plan, planner.plan_critical,
                                planner.plan_auxiliary, cmdl.fits,
                                cmdl.microbatch_time, cmdl.section_cost,
                                cmdl.sample_tuples],
                         ids=lambda f: f.__name__)
def test_no_default_hw(fn):
    hw = inspect.signature(fn).parameters["hw"]
    assert hw.default is inspect.Parameter.empty
    assert hw.kind is inspect.Parameter.KEYWORD_ONLY
