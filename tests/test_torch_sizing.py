"""The port's pre-flight sizing gate (dist_dqn_tpu_torch/utils/sizing.py),
twin of JAX's ``tests/test_sizing.py`` case for case, and the train CLI's
``--wall-budget-s`` rows.

The structural verdicts are JAX's: the override admits what the envelope
refuses, vector-obs runs skip the pixel envelope, an over-budget run and
a ring the card cannot hold are refused, and unproven sizes name the 2x
rule. The numbers are the card's, where JAX's stood for v5e: the proven
envelope is chip_smoke.py's largest clean run on an NVIDIA H100 80GB HBM3
at 700 W (64 lanes, batch 512, 1M-slot PER and dedup rings), the time
model is fitted to its main paths' walls (PERF.md §4–§6), and the memory
budget is the card's 80 GB. Each case says which card number it uses.
"""
from __future__ import annotations

import argparse
import json
import math

import pytest

from dist_dqn_tpu_torch import train as ttrain
from dist_dqn_tpu_torch.actors import service as tservice
from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
from dist_dqn_tpu_torch.envs import make_env
from dist_dqn_tpu_torch.utils import sizing

# chip_smoke.py's apex main path: 16 lanes x batch 512, 7 chunks of 250
# iterations (28,000 frames), filled at 22,000, the 1M-slot PER ring;
# 15.6 s of train() wall on the card (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §4).
APEX = dict(num_envs=16, batch_size=512, train_every=1, chunk_iters=250,
            num_chunks=7, ring=1_000_000, min_fill=22_000)
APEX_WALL_S = 15.6


def test_default_bench_config_passes_default_budget():
    # JAX's: bench.py's 1024 lanes x 512 under its 900 s watchdog. The
    # card's: chip_smoke.py's apex main path at full width under the same
    # 900 s budget.
    v = sizing.gate_fused(budget_s=900.0, **APEX)
    assert v.ok, v.reason
    assert v.predicted_s < 0.6 * 900.0


def test_sweep_variant_passes_sweep_budget():
    # JAX's: the 1024x512 and 1536x768 sweep variants under 450 s. The
    # card's: every fused main path of chip_smoke.py at its depth, under
    # the same 450 s.
    import chip_smoke

    for name, (preset, overrides, total, chunk) in \
            chip_smoke.MAIN_PATHS.items():
        cfg = apply_overrides(CONFIGS[preset], overrides)
        env = make_env(cfg.env_name, device="cpu")
        v = sizing.gate_fused(
            budget_s=450.0,
            **sizing.fused_gate_args(cfg, env, total, chunk))
        assert v.ok, (name, v.reason)


def test_incident_3_config_refused():
    # JAX's: 2048 lanes x batch 1024, PROVEN OVERSIZED on v5e. The card
    # has no measured failure (KNOWN_BAD is empty), so the same config is
    # refused as unproven: 2048 lanes is 32x the proven 64.
    assert sizing.KNOWN_BAD == {}
    v = sizing.gate_fused(budget_s=450.0, num_envs=2048, batch_size=1024,
                          train_every=4, chunk_iters=200, num_chunks=12,
                          ring=65_536)
    assert not v.ok
    assert "num_envs=2048" in v.reason and "2x" in v.reason


@pytest.mark.parametrize("kwargs,fragment", [
    # More than 2x the proven batch of 512 (JAX's: 1100 against 512 too).
    (dict(num_envs=16, batch_size=1100, ring=65_536), "batch_size"),
    # More than 2x the proven 1M-slot PER ring (JAX's: 420k against 200k).
    (dict(num_envs=16, batch_size=512, ring=2_100_000), "ring"),
])
def test_unproven_sizes_refused(kwargs, fragment):
    v = sizing.gate_fused(budget_s=10_000.0, train_every=4,
                          chunk_iters=200, num_chunks=12, **kwargs)
    assert not v.ok
    assert fragment in v.reason and "2x" in v.reason


def test_override_env_admits_unproven(monkeypatch):
    monkeypatch.setenv(sizing.OVERRIDE_ENV, "1")
    v = sizing.gate_fused(budget_s=10_000.0, num_envs=2048,
                          batch_size=1024, train_every=4, chunk_iters=200,
                          num_chunks=12, ring=65_536)
    assert v.ok, v.reason


def test_vector_obs_skips_pixel_envelope():
    # CartPole-class runs: tiny slots/lanes, envelope N/A; the time model
    # still governs (the card's vector grad step: 15 ms charged).
    v = sizing.gate_fused(budget_s=3_600.0, num_envs=4096, batch_size=2048,
                          train_every=1, chunk_iters=100, num_chunks=10,
                          ring=1_000_000, pixel_obs=False)
    assert v.ok, v.reason


def test_time_model_refuses_over_budget_run():
    # Incident-#2 shape: a frame budget far larger than the kill budget.
    # 500 chunks x 2000 iterations x 16 lanes at the card's 8 ms an
    # iteration and 45 ms a grad step cannot fit inside 560 s.
    v = sizing.gate_fused(budget_s=560.0, num_envs=16, batch_size=512,
                          train_every=4, chunk_iters=2000, num_chunks=500,
                          ring=65_536)
    assert not v.ok
    assert "kill budget" in v.reason
    assert v.predicted_s > 560.0


def test_prediction_is_conservative_vs_measured():
    # The measured apex main path (15.6 s of train() wall on the card)
    # must be predicted ABOVE its wall even on a host 1.6x slower (the
    # spread of the card's hosts, PERF.md §6), but well under a 900 s
    # budget — the gate is a guard band, not a forecast.
    v = sizing.gate_fused(budget_s=900.0, **APEX)
    assert 1.6 * APEX_WALL_S < v.predicted_s < 0.6 * 900.0


def test_dedup_ring_bound_is_measured_not_divided():
    """Slot-count-scaled device costs (the priority plane, the sampler,
    index math) do not shrink under frame dedup, so dedup rings are
    bounded by their OWN measured anchor (apex_dedup's 1M-slot ring on
    the card) — never by the stacked bound divided by the stack."""
    # The measured 1M dedup ring passes the count envelope.
    assert sizing.check_envelope(num_envs=16, batch_size=512,
                                 ring=1_000_000,
                                 frame_dedup_stack=4) is None
    # >2x the dedup-proven count is refused, naming the dedup anchor.
    reason = sizing.check_envelope(num_envs=16, batch_size=512,
                                   ring=2_500_000, frame_dedup_stack=4)
    assert reason is not None and "ring_dedup" in reason and "2x" in reason
    # The count bound holds regardless of stack depth.
    assert sizing.check_envelope(num_envs=16, batch_size=512,
                                 ring=2_500_000,
                                 frame_dedup_stack=8) is not None
    # Non-dedup rings keep the stacked anchor untouched.
    assert "ring=" in sizing.check_envelope(num_envs=16, batch_size=512,
                                            ring=2_100_000)


def test_hbm_gate_refuses_oversized_ring():
    """Four members of apex's 1M-slot PER ring (4 x 28.2 GB) are inside
    the count envelope but cannot fit the card's 80 GB; the gate must
    refuse BEFORE the allocation fails (JAX's case: a 390k ring on v5e's
    15.75 GB). Two members (56.4 GB) fit."""
    kw = dict(budget_s=10_000.0, num_envs=16, batch_size=512, train_every=1,
              chunk_iters=250, num_chunks=4, ring=1_000_000)
    v = sizing.gate_fused(members=4, **kw)
    assert not v.ok
    assert "device memory" in v.reason
    assert sizing.gate_fused(members=2, **kw).ok


def test_hbm_model_admits_the_proven_configs():
    """The measured configs must pass and be predicted above their
    measured peaks (NVIDIA H100 80GB HBM3, 700 W; PERF.md §4–§6): apex's
    1M-slot PER ring (peak 28.55 GB), apex_dedup's 1M-slot dedup ring
    (7.33 GB), r2d2's 100,000 slots (5.55 GB)."""
    limit = sizing.HBM_REFUSE_FRACTION * sizing.device_memory_bytes()
    for ring, stack, peak in ((1_000_000, 0, 28.55e9),
                              (1_000_000, 4, 7.33e9),
                              (100_000, 0, 5.55e9)):
        hbm = sizing.predict_fused_hbm_bytes(ring=ring,
                                             frame_dedup_stack=stack)
        assert peak < hbm < limit, (ring, stack, hbm)


# ---------------------------------------------------------------------------
# The train CLI's --wall-budget-s rows
# ---------------------------------------------------------------------------

def _gate(capsys, overrides=(), **kw):
    args = argparse.Namespace(total_env_steps=kw.pop("total", None),
                              chunk_iters=kw.pop("chunk_iters", 250), **kw)
    cfg = apply_overrides(CONFIGS["apex"], ["replay.min_fill=22000",
                                            "eval_every_steps=0",
                                            *overrides])
    try:
        ttrain._gate_sizing(cfg, args)
        code = None
    except SystemExit as e:
        code = e.code
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    return code, rows


def test_cli_gate_prints_prediction_and_refuses_over_budget(capsys):
    """On the card the fused runtime prints ``sizing_predicted_s`` beside
    ``wall_budget_s`` (JAX ``train.py:1350``); a run predicted over 60 % of
    the budget is refused with exit 4 (JAX's code); without a budget an
    envelope refusal only warns (nothing will kill the run mid-chunk)."""
    code, rows = _gate(capsys, wall_budget_s=900.0, total=28_000)
    assert code is None and len(rows) == 1
    assert rows[0]["wall_budget_s"] == 900.0
    assert 1.6 * APEX_WALL_S < rows[0]["sizing_predicted_s"] < 540.0
    code, rows = _gate(capsys, wall_budget_s=60.0, total=28_000)
    assert code == 4
    assert rows[1]["sizing_gate"] == "refused"
    assert "kill budget" in rows[1]["reason"]
    code, rows = _gate(capsys, ["learner.batch_size=2048"],
                       wall_budget_s=None, total=28_000)
    assert code is None
    assert rows[0]["wall_budget_s"] is None
    assert rows[1]["sizing_gate"] == "warning"
    assert "batch_size=2048" in rows[1]["reason"]


def test_cli_gate_runs_on_the_card_only(monkeypatch, capsys):
    """The fused CLI gates a card run before train() (JAX gates every
    non-CPU backend) and a ``--device cpu`` run not at all; without a card
    nothing is gated and train() raises with the reason, as before."""
    calls = []
    monkeypatch.setattr(ttrain, "_gate_sizing",
                        lambda cfg, args: calls.append(args.wall_budget_s))
    monkeypatch.setattr(ttrain, "train", lambda *a, **k: (None, []))
    monkeypatch.setattr(ttrain.torch.cuda, "is_available", lambda: True)
    ttrain.main(["--config", "cartpole", "--total-env-steps", "100",
                 "--wall-budget-s", "30"])
    ttrain.main(["--config", "cartpole", "--total-env-steps", "100",
                 "--device", "cpu", "--wall-budget-s", "30"])
    assert calls == [30.0]
    monkeypatch.setattr(ttrain.torch.cuda, "is_available", lambda: False)
    ttrain.main(["--config", "cartpole", "--total-env-steps", "100",
                 "--wall-budget-s", "30"])
    assert calls == [30.0]


class _Stub:
    def __init__(self, cfg, rt, **_):
        pass

    def run(self):
        return {"stub": True}


@pytest.mark.parametrize("runtime", ["host-replay", "apex"])
def test_cli_says_the_flag_is_not_modeled(runtime, monkeypatch, capsys):
    """Under ``--runtime host-replay`` (JAX ``train.py:1181-1186``) and
    ``--runtime apex`` the CLI says the flag is not modeled there, and
    prints no prediction."""
    from dist_dqn_tpu_torch import host_replay_loop

    monkeypatch.setattr(host_replay_loop, "run_host_replay",
                        lambda *a, **k: {"stub": True})
    monkeypatch.setattr(tservice, "ApexLearnerService", _Stub)
    ttrain.main(["--config", "cartpole", "--runtime", runtime, "--device",
                 "cpu", "--total-env-steps", "100", "--wall-budget-s",
                 "30"])
    out = capsys.readouterr().out
    lines = [x for x in out.splitlines() if "--wall-budget-s" in x]
    assert lines == [x for x in lines if x.startswith(
        f"# --wall-budget-s is not modeled for --runtime {runtime}: size "
        "the run manually")] and len(lines) == 1
    assert "sizing_predicted_s" not in out


def test_fused_gate_args_follow_the_config():
    """The CLI and chip_smoke.py derive the gate's inputs from one
    function: chunks, fill, updates per event, dedup stack, recurrence,
    members and evaluations come from the config as train() runs it."""
    cfg = apply_overrides(CONFIGS["apex"], [
        "replay.frame_dedup=true", "replay.updates_per_chunk=2",
        "replay.min_fill=22000", "population.size=2"])
    env = make_env(cfg.env_name, device="cpu")
    a = sizing.fused_gate_args(cfg, env, 28_000, 125)
    assert a["num_chunks"] == math.ceil(28_000 / (125 * 16)) == 14
    assert (a["min_fill"], a["updates_per_train"], a["members"]) == \
        (22_000, 2, 2)
    assert a["frame_dedup_stack"] == 4 and a["pixel_obs"]
    assert a["num_evals"] == math.ceil(28_000 / cfg.eval_every_steps)
    assert a["eval_iters"] == env.max_steps
    r2d2 = apply_overrides(CONFIGS["r2d2"], [])
    a = sizing.fused_gate_args(r2d2, make_env(r2d2.env_name, device="cpu"),
                               3_600, 25)
    assert a["recurrent"] and a["frame_dedup_stack"] == 0
