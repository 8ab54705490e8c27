"""Port parity of the n-step fold and the one-step TD error of
``ops/losses.py`` (``n_step_from_rollout``, ``q_learning_error``) against
the JAX package's, called without ``jit``: float32 inputs made with numpy
give the same bits, the fold equals the brute force of JAX's own test
(tests/test_losses.py), an ``n`` outside ``[1, T]`` is refused with JAX's
text, and the TD error's gradient flows into ``q`` only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.ops import losses as jlosses
from dist_dqn_tpu_torch.ops import losses as tlosses


def _rollout(shape, seed):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=shape).astype(np.float32)
    # gamma * (1 - terminated_t), one step in ten terminal.
    discounts = (0.99 * (rng.random(shape) > 0.1)).astype(np.float32)
    return rewards, discounts


@pytest.mark.parametrize("shape,n", [((12,), 4), ((512, 64, 40), 5),
                                     ((3, 7, 20), 20), ((8, 1), 1)])
def test_n_step_from_rollout_matches_jax_bitwise(shape, n):
    rewards, discounts = _rollout(shape, seed=sum(shape) + n)
    want_r, want_d = jlosses.n_step_from_rollout(
        jnp.asarray(rewards), jnp.asarray(discounts), n)
    got_r, got_d = tlosses.n_step_from_rollout(
        torch.from_numpy(rewards), torch.from_numpy(discounts), n)
    out = shape[:-1] + (shape[-1] - n + 1,)
    assert got_r.shape == got_d.shape == out
    assert got_r.dtype == got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_n_step_from_rollout_matches_bruteforce(dtype):
    """Twin of JAX's ``test_n_step_from_rollout_matches_bruteforce``; the
    fold keeps its inputs' dtype."""
    rng = np.random.default_rng(0)
    T, n = 12, 4
    rewards = rng.normal(size=(T,)).astype(np.float32)
    discounts = (0.9 * rng.integers(0, 2, size=(T,))).astype(np.float32)
    got_r, got_d = tlosses.n_step_from_rollout(
        torch.from_numpy(rewards).to(dtype),
        torch.from_numpy(discounts).to(dtype), n)
    assert got_r.dtype == got_d.dtype == dtype
    assert got_r.shape == got_d.shape == (T - n + 1,)
    for t in range(T - n + 1):
        acc, d = 0.0, 1.0
        for k in range(n):
            acc += d * rewards[t + k]
            d *= discounts[t + k]
        np.testing.assert_allclose(got_r[t].item(), acc, rtol=1e-5)
        np.testing.assert_allclose(got_d[t].item(), d, rtol=1e-5)


@pytest.mark.parametrize("n", [0, 13])
def test_n_step_from_rollout_refuses_as_jax_does(n):
    rewards, discounts = _rollout((12,), seed=1)
    with pytest.raises(ValueError) as jax_err:
        jlosses.n_step_from_rollout(jnp.asarray(rewards),
                                    jnp.asarray(discounts), n)
    with pytest.raises(ValueError) as port_err:
        tlosses.n_step_from_rollout(torch.from_numpy(rewards),
                                    torch.from_numpy(discounts), n)
    assert str(port_err.value) == str(jax_err.value) == \
        f"n_step={n} out of range for rollout length 12"


def _td_inputs(action_dtype, seed=3, batch=64, num_actions=6):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(batch, num_actions)).astype(np.float32)
    actions = rng.integers(0, num_actions, batch).astype(action_dtype)
    rewards = rng.normal(size=batch).astype(np.float32)
    discounts = (0.99 * (rng.random(batch) > 0.1)).astype(np.float32)
    bootstrap_q = rng.normal(size=batch).astype(np.float32)
    return q, actions, rewards, discounts, bootstrap_q


@pytest.mark.parametrize("action_dtype", [np.int32, np.int64])
def test_q_learning_error_matches_jax_bitwise(action_dtype):
    arrays = _td_inputs(action_dtype)
    want = jlosses.q_learning_error(*map(jnp.asarray, arrays))
    got = tlosses.q_learning_error(*map(torch.from_numpy, arrays))
    assert got.shape == (64,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("action_dtype", [np.int32, np.int64])
def test_q_learning_error_gradient_flows_into_q_only(action_dtype):
    q, actions, rewards, discounts, bootstrap_q = _td_inputs(action_dtype)

    def jax_loss(q, rewards, discounts, bootstrap_q):
        return jlosses.q_learning_error(q, jnp.asarray(actions), rewards,
                                        discounts, bootstrap_q).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (q, rewards, discounts, bootstrap_q)))
    tq, tr, td, tb = (torch.from_numpy(x).requires_grad_()
                      for x in (q, rewards, discounts, bootstrap_q))
    tlosses.q_learning_error(tq, torch.from_numpy(actions), tr, td,
                             tb).sum().backward()
    np.testing.assert_array_equal(tq.grad.numpy(), np.asarray(want[0]))
    # JAX's stop_gradient hands the target's inputs zeros; the port's
    # detach leaves them out of the graph.
    for g in want[1:]:
        np.testing.assert_array_equal(np.asarray(g), 0.0)
    assert tr.grad is None and td.grad is None and tb.grad is None
