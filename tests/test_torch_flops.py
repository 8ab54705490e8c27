"""Model-FLOPs accounting of the port (dist_dqn_tpu_torch/utils/flops.py)
against the JAX package's (tests/test_flops.py): the analytic counts equal
JAX's; the census of the port's Nature-CNN forward is within JAX's own
1.5x of the analytic count; the port's train-step census, on weights
carried across from flax, is within 1.25x of XLA's census of the same
scan-free step; the R2D2 cell census matches the analytic cell model; the
peaks, MFU and roofline maths key on the card's name (an injected H100
here; the CPU has none); and a census leaves the live state bit-equal."""
import dataclasses

import numpy as np
import pytest
import torch

from dist_dqn_tpu.utils import flops as jflops
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.types import SequenceSample, Transition
from dist_dqn_tpu_torch.utils import flops as tflops
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import assert_trees_equal, to_numpy_tree

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("batch,hidden,actions", [
    (1, 512, 0), (32, 512, 6), (256, 256, 18), (64 * 125, 512, 0)])
def test_analytic_counts_equal_jax(batch, hidden, actions):
    assert tflops.nature_cnn_fwd_flops(batch, hidden, actions) == \
        jflops.nature_cnn_fwd_flops(batch, hidden, actions)
    assert tflops.lstm_cell_fwd_flops(batch, hidden, 512) == \
        jflops.lstm_cell_fwd_flops(batch, hidden, 512)
    for remat in (True, False):
        assert tflops.r2d2_grad_step_flops(125, 64, hidden=hidden,
                                           remat=remat) == \
            jflops.r2d2_grad_step_flops(125, 64, hidden=hidden, remat=remat)


def test_census_matches_analytic_nature_cnn():
    """The port's Nature CNN (the atari preset's net, 6 actions) on 32
    frames: the census within JAX's 1.5x of the analytic count."""
    from dist_dqn_tpu_torch.models import build_network

    cfg = tconfig.CONFIGS["atari"]
    net = build_network(cfg.network, 6, (84, 84, 4), device="cpu", seed=0)
    obs = torch.zeros((32, 84, 84, 4), dtype=torch.uint8)
    got = tflops.census(net, obs)["flops"]
    want = tflops.nature_cnn_fwd_flops(32, num_actions=6)
    assert want / 1.5 < got < want * 1.5, (got, want)


def test_train_step_census_matches_jax_and_exceeds_forward():
    """JAX's feed-forward train step (benchmarks/learner_bench.py) and the
    port's on the same weights (from_flax) and batch: fwd(online) +
    fwd(target) + fwd(double-Q) + backward, well over 3 forwards, and
    within 1.25x of XLA's census (which counts the elementwise ops too;
    the port's counter counts the convs and matmuls)."""
    from benchmarks.learner_bench import (NUM_ACTIONS, OBS_SHAPE,
                                          _feedforward_case)
    from dist_dqn_tpu.config import CONFIGS
    from dist_dqn_tpu_torch.agents.dqn import make_learner
    from dist_dqn_tpu_torch.models import build_network

    state, step, (batch, weights) = _feedforward_case(CONFIGS["atari"])
    want = jflops.compiled_flops(step.lower(state, batch, weights).compile())
    cfg = tconfig.CONFIGS["atari"]
    net = build_network(cfg.network, NUM_ACTIONS, OBS_SHAPE, device="cpu",
                        seed=0)
    net.load_state_dict(from_flax(to_numpy_tree(state.params), net))
    init, train_step = make_learner(cfg.learner, net)
    tb = Transition(*(torch.from_numpy(np.array(x)) for x in batch))
    got = tflops.census(train_step, init(net), tb,
                        torch.from_numpy(np.array(weights)))
    fwd = tflops.nature_cnn_fwd_flops(cfg.learner.batch_size,
                                      num_actions=NUM_ACTIONS)
    assert got["flops"] > 3.0 * fwd, (got, fwd)
    assert want / 1.25 < got["flops"] < want * 1.25, (got, want)
    # Unfused bytes: at least both batches' frames, read once.
    assert got["bytes"] > 2 * tb.obs.numel()


def test_r2d2_analytic_cell_flops_match_census():
    """The R2D2 analytic cell model against the census of a tiny train
    step whose cell dominates (tiny MLP torso, big LSTM): the census runs
    every time step, as JAX's fully unrolled program does."""
    from dist_dqn_tpu_torch.agents.r2d2 import make_r2d2_learner
    from dist_dqn_tpu_torch.models import build_network

    base = tconfig.CONFIGS["r2d2"]
    S, lstm, E = 8, 128, 8
    cfg = dataclasses.replace(
        base,
        network=dataclasses.replace(
            base.network, torso="mlp", mlp_features=(E,), hidden=E,
            lstm_size=lstm, compute_dtype="float32", remat_torso=False),
        replay=dataclasses.replace(base.replay, burn_in=4, unroll_length=6,
                                   sequence_stride=3),
        learner=dataclasses.replace(base.learner, n_step=2, batch_size=S))
    T = cfg.replay.burn_in + cfg.replay.unroll_length + cfg.learner.n_step
    net = build_network(cfg.network, 2, (4,), device="cpu", seed=0)
    init, train_step = make_r2d2_learner(cfg.learner, cfg.replay)
    r = np.random.default_rng(0)
    sample = SequenceSample(
        obs=torch.from_numpy(r.normal(size=(T, S, 4)).astype(np.float32)),
        action=torch.from_numpy(r.integers(0, 2, (T, S))),
        reward=torch.from_numpy(r.normal(size=(T, S)).astype(np.float32)),
        done=torch.zeros((T, S), dtype=torch.bool),
        reset=torch.zeros((T, S), dtype=torch.bool),
        start_state=net.initial_state(S),
        weights=torch.ones(S), t_idx=torch.zeros(S, dtype=torch.int64),
        b_idx=torch.zeros(S, dtype=torch.int64))
    census = tflops.census(train_step, init(net), sample)["flops"]
    analytic_cell = 4.0 * tflops.lstm_cell_fwd_flops(T * S, E, lstm)
    assert analytic_cell / 1.6 < census < analytic_cell * 1.9, \
        (census, analytic_cell)


def test_r2d2_time_model_orders_knobs():
    """bf16 gates and a deeper unroll reduce modeled time; the default
    peak is the H100's bf16 figure, and f32 gates cost the TF32 rate."""
    T, B = 125, 64
    f32 = tflops.r2d2_time_model(T, B, lstm_bf16=False, unroll=1)
    bf16 = tflops.r2d2_time_model(T, B, lstm_bf16=True, unroll=1)
    bf16_u8 = tflops.r2d2_time_model(T, B, lstm_bf16=True, unroll=8)
    assert bf16["total_s"] < f32["total_s"]
    assert bf16_u8["total_s"] < bf16["total_s"]
    f = tflops.r2d2_grad_step_flops(T, B)
    assert bf16["torso_s"] == pytest.approx(f["torso"] / 989.4e12)
    assert f32["cell_s"] == pytest.approx(2 * bf16["cell_s"])


def test_peak_lookup_and_mfu(h100):
    assert tflops.chip_peak_flops(h100) == 989.4e12
    assert tflops.chip_peak_hbm_bw(h100) == 3.35e12
    assert abs(tflops.mfu(98.94e12, h100) - 0.1) < 1e-9
    cpu = torch.device("cpu")  # unknown kind -> None
    assert tflops.chip_peak_flops(cpu) is None
    assert tflops.chip_peak_flops(None) is None
    assert tflops.mfu(1e12, cpu) is None
    assert tflops.mfu(None, h100) is None
    assert tflops.mfu_fields(1e12, 10, 2.0, h100) == {
        "model_flops_per_sec": 5e12, "mfu": round(5e12 / 989.4e12, 4)}
    assert tflops.mfu_fields(1e12, 10, 2.0, cpu) == {
        "model_flops_per_sec": 5e12}
    assert tflops.mfu_fields(None, 10, 2.0, h100) == {}


def test_unknown_card_has_no_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert tflops.chip_peak_flops(torch.device("cuda")) is None


def test_census_bytes():
    def f(a, b):
        return torch.tanh(a @ b).sum()

    c = tflops.census(f, torch.zeros(64, 32), torch.zeros(32, 16))
    # At least the operands + output must be accessed once.
    assert c["bytes"] is not None
    assert c["bytes"] >= (64 * 32 + 32 * 16 + 1) * 4
    assert c["flops"] == 2 * 64 * 32 * 16

    def boom(a):
        raise RuntimeError("a program that fails")

    assert tflops.census(boom, torch.zeros(2)) == {"flops": None,
                                                    "bytes": None}


def test_roofline_fields_math(h100):
    # 0.1 ms of compute, 0.2 ms of memory traffic -> memory-bound.
    fl = 989.4e12 * 1e-4
    by = 3.35e12 * 2e-4
    out = tflops.roofline_fields(fl, by, h100)
    assert out["roofline_bound"] == "memory"
    assert out["roofline_s"] == pytest.approx(2e-4, rel=1e-3)
    assert out["roofline_compute_s"] == pytest.approx(1e-4, rel=1e-3)
    assert out["arith_intensity"] == pytest.approx(fl / by, rel=1e-2)
    out = tflops.roofline_fields(fl * 4, by, h100)
    assert out["roofline_bound"] == "compute"
    cpu = torch.device("cpu")
    assert tflops.roofline_fields(fl, by, cpu) == {}
    assert tflops.roofline_fields(None, by, h100) == {}


def test_sampler_cost_is_the_kernel_bound_count():
    """The sampler's cost from its shapes: the bytes and operations that
    chip_smoke.py divides by the card's rates for the kernel's bound."""
    c = tflops.stratified_sample_cost(1954, 512, 512)
    assert c["bytes"] == 1954 * 512 * 4 + 512 * 4 + 512 * 12 + 4
    assert c["flops"] == 1954 * 512 + 1954 + 512 * (11 + 512)
    assert tflops.stratified_sample_cost(62500, 16, 512, members=4)[
        "bytes"] == 4 * tflops.stratified_sample_cost(62500, 16, 512)["bytes"]
    assert tflops.scaled_sum([(2, c), (0.5, c)])["flops"] == 2.5 * c["flops"]
    assert tflops.scaled_sum([(1, c), (1, {"flops": None,
                                           "bytes": 1.0})])["flops"] is None


def _carry_tensors(carry) -> dict:
    """Every tensor and generator state of a fused carry, by path."""
    from dist_dqn_tpu_torch.utils.checkpoint import state_tree

    out = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = x.detach().clone()
        elif isinstance(x, torch.Generator):
            out[path] = x.get_state()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = x

    walk(state_tree(carry), "carry")
    return out


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_census_leaves_the_live_carry_bit_equal(per):
    """Two fused runs from one seed, one taking the chunk census (the
    ``fused.chunk`` cost: an act and a train step on copies) between its
    chunks: their carries stay bit-equal, generators included, and the
    census is positive."""
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.train_loop import make_fused_train

    cfg = tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], [
        "replay.capacity=2048", "replay.min_fill=64",
        "network.mlp_features=(16,)", "learner.batch_size=16",
        "actor.num_envs=8", f"replay.prioritized={str(per).lower()}"])
    carries, costs = [], []
    for take_census in (False, True):
        env = make_env(cfg.env_name, device="cpu")
        net = build_network(cfg.network, env.num_actions,
                            env.observation_shape, device="cpu", seed=0)
        init, run_chunk = make_fused_train(cfg, env, net, device="cpu")
        carry = init(0)
        for _ in range(3):
            carry, _ = run_chunk(carry, 20)
            if take_census:
                costs.append(run_chunk.chunk_cost(carry, 20))
        carries.append(_carry_tensors(carry))
    a, b = carries
    assert set(a) == set(b)
    for path in a:
        if isinstance(a[path], torch.Tensor):
            assert torch.equal(a[path], b[path]), path
        else:
            assert a[path] == b[path], path
    assert all(c["flops"] > 0 and c["bytes"] > 0 for c in costs)
    # A training chunk's grad steps and acts: one census per chunk size.
    assert costs[0] == costs[-1]


def test_census_leaves_a_learner_bit_equal():
    """The train-step census (host replay's and the service's program
    cost) on copies: the learner's params, optimizer state, step count
    and generator are untouched."""
    from dist_dqn_tpu_torch.agents.dqn import make_learner
    from dist_dqn_tpu_torch.models import build_network

    cfg = tconfig.CONFIGS["cartpole"]
    net = build_network(cfg.network, 2, (4,), device="cpu", seed=0)
    init, train_step = make_learner(cfg.learner, net)
    state = init(net)
    r = np.random.default_rng(0)
    batch = Transition(
        obs=torch.from_numpy(r.normal(size=(16, 4)).astype(np.float32)),
        action=torch.from_numpy(r.integers(0, 2, 16)),
        reward=torch.zeros(16), discount=torch.ones(16),
        next_obs=torch.from_numpy(r.normal(size=(16, 4)).astype(np.float32)))
    before = {k: v.detach().clone()
              for k, v in state.net.state_dict().items()}
    gen = state.generator.get_state()
    steps, moments = state.steps, [m.clone() for m in state.opt_state.mu]
    assert tflops.census(train_step, state, batch,
                         torch.ones(16))["flops"] > 0
    assert_trees_equal(before, dict(state.net.state_dict()))
    assert torch.equal(gen, state.generator.get_state())
    assert state.steps == steps
    assert all(torch.equal(a, b) for a, b in zip(moments,
                                                 state.opt_state.mu))
    assert all(p.grad is None for p in state.net.parameters())
