"""The port's cost model, planner and auto-tuner: the reference's
test_planner.py (which imports jax) restated without it for the H100, the
reference's test_planner_rules_lockstep (test_auto_tuner_telemetry.py, bound
elsewhere but for this one, which builds a TPU planner), and the cost
model's own surface.

The reference calibrates against its TPU runs and expects TPU plans (remat
forced and B8 refused on a 16 GB chip; TP4 x PP2 for Llama-2-7B on 8
chips). The port's planner is calibrated on this repository's H100 runs
(GPT-1.3B B4 S1024 at 16772.0 tokens/s, the 350M-class ``train_s2048`` at
31501.5, PERF.md section 5) and plans 80 GB cards joined by NVLink, so
where the plan differs the test states the H100's plan and why."""
import numpy as np
import pytest

from paddle_tpu_torch._testing import share_the_cores_fixture
from paddle_tpu_torch.cost_model import GPU_SPECS, CostModel, OpCost
from paddle_tpu_torch.distributed.planner import (ModelSpec, PlanCandidate,
                                                  Planner)

_share_the_cores = share_the_cores_fixture()

GPT13 = ModelSpec.gpt(1.3e9, layers=24, hidden=2048, heads=16,
                      seq=1024, vocab=50304)
LLAMA7 = ModelSpec.gpt(6.7e9, layers=32, hidden=4096, heads=32,
                       seq=2048, vocab=32000)


def test_calibration_against_recorded_runs():
    """One H100, GPT-1.3B B4 S1024: the calibrated model predicts the
    measured 16772 tokens/s within 30% for the remat plan the run used. With
    80 GB the memory is not binding: the top plan drops remat (the TPU's
    16 GB forced it) and B8 is feasible (it was the TPU's OOM boundary)."""
    p = Planner("H100")
    plans = p.plan(GPT13, 1, global_batch=4)
    remat = next(c for c in plans if c.remat)
    assert 0.7 * 16_772 <= p.throughput(remat, GPT13, 4, 1) <= 1.3 * 16_772
    assert not plans[0].remat
    assert p.plan(GPT13, 1, global_batch=8)


def test_1p3b_8cards_reproduces_hand_config():
    """BASELINE 'GPT-3 1.3B DP+sharding-1': pure data parallelism with
    optimizer sharding, as on the TPU."""
    best = Planner("H100").plan(GPT13, 8, global_batch=256)[0]
    assert (best.dp, best.tp, best.pp) == (8, 1, 1), best.short()
    assert best.zero >= 1, best.short()


def test_7b_8cards_needs_model_parallelism():
    """Llama-2-7B on 8 cards: pure dp without ZeRO-3 does not fit (76 GB
    of the 80), so the top plan shards the model. On NVLink the planner
    takes tp without pp (a stage of all 32 layers fits at tp >= 2), where
    the TPU's top 5 held a tp x pp plan."""
    p = Planner("H100")
    plans = p.plan(LLAMA7, 8, global_batch=32)
    best = plans[0]
    assert best.tp > 1 or best.pp > 1 or best.zero == 3, best.short()
    assert best.tp >= 2 and all(c.pp == 1 for c in plans)
    assert p.estimate(PlanCandidate(dp=8), LLAMA7, 32).est_mem_bytes > \
        p.hbm_feasible_frac * p.hbm
    assert not [c for c in plans if (c.dp, c.tp, c.pp, c.zero)
                == (8, 1, 1, 0)]


def test_7b_engine_capable_plan():
    """Constrained to the ZeRO stages the engines run (<= 1), the top plan
    for 7B on 8 H100s is dp2 x tp4 with sp (the TPU's was TP4 x PP2)."""
    best = Planner("H100", zero_stages=(0, 1)).plan(LLAMA7, 8,
                                                    global_batch=32)[0]
    assert (best.dp, best.tp, best.pp) == (2, 4, 1), best.short()
    assert best.sp and best.collective_matmul


def test_larger_meshes_plan():
    p = Planner("H100")
    for n in (16, 32):
        best = p.plan(LLAMA7, n, global_batch=256)[0]
        assert best.dp * best.tp * best.pp == n
        assert best.dp >= n // 4, best.short()


def test_infeasible_raises():
    with pytest.raises(RuntimeError, match="no feasible"):
        Planner("H100").plan(ModelSpec.gpt(70e9, 80, 8192, 64, 4096, 32000),
                             1, 8)


def test_breakdown_and_tie_break():
    plans = Planner("H100").plan(GPT13, 8, global_batch=256)
    for c in plans:
        assert c.est_step_s > 0 and "compute" in c.breakdown
        assert sum(c.breakdown.values()) == pytest.approx(c.est_step_s)
    dp8 = [c for c in plans if (c.dp, c.tp, c.pp) == (8, 1, 1)]
    for a, b in zip(dp8, dp8[1:]):
        assert (round(a.est_step_s, 3), a.est_mem_bytes) <= \
               (round(b.est_step_s, 3), b.est_mem_bytes)


def test_top1_validates_via_dryrun():
    """The planner's choice for a small model on one card runs a real
    gpt_hybrid step of the port (the reference's 'plan must run' check,
    on the one card a CPU test has)."""
    import torch
    from paddle_tpu_torch.models import gpt_hybrid as TH
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=4,
                    num_heads=4, max_seq_len=16)
    best = Planner("H100", zero_stages=(0, 1)).plan(
        ModelSpec.from_config(cfg), 1, global_batch=16)[0]
    pcfg = best.to_parallel_config(param_dtype=torch.float32,
                                   compute_dtype=torch.float32)
    assert isinstance(pcfg, TH.ParallelConfig)
    params, opt, step = TH.setup(cfg, pcfg, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128,
                                                            (16, 16)))
    assert np.isfinite(float(step(params, opt, (ids, ids))[2]))


def test_model_spec_from_config():
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig(vocab_size=50257, hidden_size=2048, num_layers=24,
                    num_heads=16, max_seq_len=1024)
    assert 1.1e9 < ModelSpec.from_config(cfg).n_params < 1.6e9


def test_plan_to_parallel_config_carries_collective_matmul():
    p = PlanCandidate(dp=2, tp=4, pp=1, sp=True, zero=1, microbatches=1)
    pcfg = p.to_parallel_config()
    assert pcfg.collective_matmul and pcfg.zero1 and pcfg.tp == 4
    assert "+cm" in p.short()
    p2 = PlanCandidate(dp=1, tp=4, pp=2, sp=True, microbatches=4)
    pcfg2 = p2.to_parallel_config(remat=False)
    assert not pcfg2.collective_matmul and pcfg2.fused_ce
    pcfg2r = p2.to_parallel_config(remat=False, fused_ce=False)
    assert pcfg2r.collective_matmul and pcfg2r.pp_schedule == "1f1b"
    assert pcfg2r.remat is False
    p3 = PlanCandidate(dp=1, tp=4, pp=2, sp=False, microbatches=4)
    assert not p3.to_parallel_config(fused_ce=False).collective_matmul


def test_plan_to_parallel_config_zero_bubble_knob():
    p = PlanCandidate(dp=2, tp=1, pp=4, microbatches=8)
    assert p.to_parallel_config(zero_bubble=True).pp_schedule == "zbh1"
    assert p.to_parallel_config().pp_schedule == "1f1b"
    p_tp = PlanCandidate(dp=1, tp=2, pp=4, microbatches=8)
    assert p_tp.to_parallel_config(zero_bubble=True).pp_schedule == "zbh1"
    p1 = PlanCandidate(dp=8, tp=1, pp=1)
    assert p1.to_parallel_config(zero_bubble=True).pp_schedule == "gpipe"
    assert p.to_parallel_config(
        zero_bubble="zbvpp").pp_schedule == "zbvpp"
    with pytest.raises(ValueError, match="zero_bubble"):
        p.to_parallel_config(zero_bubble="zb2p")


def test_planner_rules_lockstep():
    """test_auto_tuner_telemetry.py::test_planner_rules_lockstep for the
    H100: every config candidates() enumerates passes refusal_reason, so
    the tuner's pruning cannot drift from the planner's search space."""
    spec = ModelSpec.gpt(n_params=350e6, layers=24, hidden=1024,
                         heads=16, seq=1024, vocab=50304)
    pl = Planner("H100")
    cands = pl.candidates(spec, n_chips=8, global_batch=16)
    assert cands
    for p in cands:
        assert pl.refusal_reason(
            spec, 8, 16, dp=p.dp, tp=p.tp, pp=p.pp,
            microbatches=p.microbatches, zero=p.zero) is None, p.short()


def test_tune_writes_trials_under_the_cache_dir(tmp_path, monkeypatch):
    """auto_tuner.tune over the world-1 candidates with the default trials
    file, which lives under $PADDLE_TPU_CACHE_DIR; a second sweep
    warm-starts from it."""
    from paddle_tpu_torch.distributed import auto_tuner as T
    monkeypatch.setenv("PADDLE_TPU_CACHE_DIR", str(tmp_path))
    path = T.default_trials_path()
    assert path == str(tmp_path / "auto_tuner_trials.jsonl")
    cands = T.generate_candidates(1, 24, 8, num_heads=16)
    assert [(c.dp, c.pp, c.tp) for c in cands] == [(1, 1, 1)]
    runs = []

    def run_fn(c):
        runs.append(c.key)
        return 0.25
    best = T.tune(run_fn, cands, verbose=False, trials_path=path)
    assert best.score == pytest.approx(4.0) and len(runs) == 1
    T.tune(run_fn, T.generate_candidates(1, 24, 8), verbose=False,
           trials_path=path)
    assert len(runs) == 1
    assert T.planner_guided_candidates(GPT13, 1, 4)[0].plan is not None


def test_cost_model_is_the_cards():
    """The specs are the H100's own (no TPU figure); collectives cost over
    NVLink; profile_measure times a callable on the CPU with perf_counter
    (and with CUDA events on the card)."""
    assert set(GPU_SPECS) == {"H100"}
    spec = GPU_SPECS["H100"]
    assert (spec["flops"], spec["hbm_bw"], spec["nvlink_bw"],
            spec["hbm_bytes"]) == (989e12, 3.35e12, 450e9, 80e9)
    cm = CostModel()
    c = cm.collective_cost("all_reduce", 1e9, 8)
    assert c.time_s == pytest.approx(2 * 7 / 8 * 1e9 / 450e9)
    assert cm.collective_cost("all_gather", 1e9, 1).time_s == 0
    mm = cm.matmul_cost(4096, 4096, 4096)
    assert mm.time_s == pytest.approx(2 * 4096 ** 3 / 989e12)
    total = mm + OpCost(time_s=1.0)
    assert total.time_s == pytest.approx(mm.time_s + 1.0)
    with pytest.raises(ValueError, match="unknown chip"):
        CostModel("v5e")
    import torch
    x = torch.ones(64, 64)
    assert cm.profile_measure(lambda a: a @ a, [x], steps=3, warmup=1) > 0
