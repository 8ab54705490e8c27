"""Port parity of the service-side n-step assembler
(dist_dqn_tpu_torch/actors/assembler.py) against the JAX package's
``NStepAssembler``: on the same step stream (random rewards, terminations
and truncations, several lanes) both emit the same transitions, q planes
and bootstrap lanes (the service's priority fold over them is held against
the JAX service in tests/test_torch_apex_service.py). Exact: both are
numpy."""
import numpy as np
import pytest

from dist_dqn_tpu.actors.assembler import NStepAssembler as JAssembler
from dist_dqn_tpu_torch.actors.assembler import NStepAssembler


def _stream(rng, lanes, steps, obs_shape=(3,)):
    for _ in range(steps):
        yield dict(
            obs=rng.normal(size=(lanes,) + obs_shape).astype(np.float32),
            action=rng.integers(0, 4, lanes),
            reward=rng.normal(size=lanes).astype(np.float32),
            terminated=rng.uniform(size=lanes) < 0.08,
            truncated=rng.uniform(size=lanes) < 0.05,
            next_obs=rng.normal(size=(lanes,) + obs_shape).astype(
                np.float32),
            q_sel=rng.normal(size=lanes).astype(np.float32),
            q_max=rng.normal(size=lanes).astype(np.float32))


def _drain_all(asm, steps, with_q):
    out = []
    for step in steps:
        kw = {} if with_q else {k: step[k] for k in step
                                if k not in ("q_sel", "q_max")}
        asm.step(**(step if with_q else kw))
        emitted = asm.drain()
        out.append(emitted)
    return out


@pytest.mark.parametrize("n_step,gamma", [(1, 0.99), (3, 0.97), (5, 0.9)])
@pytest.mark.parametrize("with_q", [False, True])
def test_transitions_match_jax(n_step, gamma, with_q):
    steps = list(_stream(np.random.default_rng(n_step), 4, 120))
    got = _drain_all(NStepAssembler(4, n_step, gamma, with_q=with_q), steps,
                     with_q)
    want = _drain_all(JAssembler(4, n_step, gamma, with_q=with_q), steps,
                      with_q)
    emitted = 0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        emitted += len(g["action"])
    assert emitted > 300


def test_with_q_needs_the_planes_and_reset_drops_open_windows():
    asm = NStepAssembler(2, 3, 0.99, with_q=True)
    step = next(_stream(np.random.default_rng(0), 2, 1))
    with pytest.raises(ValueError, match="q_sel and q_max"):
        asm.step(**{k: v for k, v in step.items() if k != "q_max"})
    step["terminated"][:] = False
    step["truncated"][:] = False
    asm.step(**step)
    asm.reset()
    assert all(not lane.obs for lane in asm.lanes)
    assert asm.drain() is None
