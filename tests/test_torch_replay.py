"""Port parity: the device ring and the prioritized ring
(dist_dqn_tpu_torch/replay/) against the JAX package, exactly.

Both rings take the same numpy trajectory — random rewards, terminations
and truncations, wrapping the ring twice — and are gathered at the same
fixed (t, b) pairs; every field of the n-step transitions must match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.replay import device as jring
from dist_dqn_tpu.replay import prioritized_device as jpring
from dist_dqn_tpu_torch.replay import device as tring
from dist_dqn_tpu_torch.replay import prioritized_device as tpring

T, B, OBS = 24, 4, (3, 2)


def _trajectory(steps, seed=0):
    rng = np.random.default_rng(seed)
    for k in range(steps):
        obs = rng.integers(0, 255, (B,) + OBS).astype(np.uint8)
        final = rng.integers(0, 255, (B,) + OBS).astype(np.uint8)
        action = rng.integers(0, 6, B).astype(np.int32)
        reward = rng.normal(size=B).astype(np.float32)
        term = rng.uniform(size=B) < 0.15
        trunc = ~term & (rng.uniform(size=B) < 0.1)
        yield obs, action, reward, term, trunc, final


def _flat(x, merge):
    return x.reshape(x.shape[0], -1) if merge else x


def _fill(steps, store_final, merge):
    example = np.zeros(OBS, np.uint8)
    ex = example.reshape(-1) if merge else example
    js = jring.time_ring_init(T, B, jnp.asarray(ex),
                              store_final_obs=store_final,
                              merge_obs_rows=merge)
    ts = tring.time_ring_init(T, B, torch.from_numpy(ex),
                              store_final_obs=store_final,
                              merge_obs_rows=merge)
    for obs, action, reward, term, trunc, final in _trajectory(steps):
        obs, final = _flat(obs, merge), _flat(final, merge)
        js = jring.time_ring_add(
            js, jnp.asarray(obs), jnp.asarray(action), jnp.asarray(reward),
            jnp.asarray(term), jnp.asarray(trunc),
            final_obs=jnp.asarray(final) if store_final else None,
            merge_obs_rows=merge)
        tring.time_ring_add(
            ts, torch.from_numpy(obs), torch.from_numpy(action),
            torch.from_numpy(reward), torch.from_numpy(term),
            torch.from_numpy(trunc),
            final_obs=torch.from_numpy(final) if store_final else None,
            merge_obs_rows=merge)
    return js, ts


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("store_final", [False, True])
@pytest.mark.parametrize("steps", [10, 2 * T + 5])   # partial, wrapped
def test_ring_add_and_gather_exact(steps, store_final, merge):
    js, ts = _fill(steps, store_final, merge)
    assert (ts.pos, ts.size) == (int(js.pos), int(js.size))
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(js.obs))
    np.testing.assert_array_equal(ts.action.numpy(), np.asarray(js.action))
    for name in ("reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    n_step, gamma = 3, 0.97
    # Every valid window start in every lane.
    valid = int(js.size) - n_step
    starts = (int(js.pos) - int(js.size) + np.arange(valid)) % T
    t_idx = np.repeat(starts, B).astype(np.int32)
    b_idx = np.tile(np.arange(B), valid).astype(np.int32)
    want = jring.gather_transitions(js, jnp.asarray(t_idx),
                                    jnp.asarray(b_idx), n_step, gamma,
                                    merge_obs_rows=merge)
    got = tring.gather_transitions(ts, torch.from_numpy(t_idx),
                                   torch.from_numpy(b_idx), n_step, gamma,
                                   merge_obs_rows=merge)
    for field in ("obs", "action", "reward", "discount", "next_obs"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    # The trajectory crosses episode boundaries inside windows.
    assert (np.asarray(want.discount) == 0).any()


def test_compute_n_step_exact():
    rng = np.random.default_rng(1)
    S, n = 64, 5
    reward = rng.normal(size=(S, n)).astype(np.float32)
    term = rng.uniform(size=(S, n)) < 0.2
    trunc = ~term & (rng.uniform(size=(S, n)) < 0.2)
    want = jring.compute_n_step(jnp.asarray(reward), jnp.asarray(term),
                                jnp.asarray(trunc), 0.99)
    got = tring.compute_n_step(torch.from_numpy(reward),
                               torch.from_numpy(term),
                               torch.from_numpy(trunc), 0.99)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("steps", [10, 2 * T + 5])
def test_prioritized_ring_masks_and_writes_exact(steps):
    example = np.zeros(OBS, np.uint8)
    js = jpring.prioritized_ring_init(T, B, jnp.asarray(example))
    ts = tpring.prioritized_ring_init(T, B, torch.from_numpy(example))
    rng = np.random.default_rng(2)
    for k, (obs, action, reward, term, trunc, _) in enumerate(
            _trajectory(steps)):
        js = jpring.prioritized_ring_add(
            js, jnp.asarray(obs), jnp.asarray(action), jnp.asarray(reward),
            jnp.asarray(term), jnp.asarray(trunc))
        tpring.prioritized_ring_add(
            ts, torch.from_numpy(obs), torch.from_numpy(action),
            torch.from_numpy(reward), torch.from_numpy(term),
            torch.from_numpy(trunc))
        if k % 4 == 3:   # interleaved write-backs raise max_priority
            t_idx = rng.integers(0, T, 8).astype(np.int32)
            b_idx = rng.integers(0, B, 8).astype(np.int32)
            prio = (rng.normal(size=8) * 2).astype(np.float32)
            js = jpring.prioritized_ring_update(
                js, jnp.asarray(t_idx), jnp.asarray(b_idx),
                jnp.asarray(prio))
            tpring.prioritized_ring_update(
                ts, torch.from_numpy(t_idx), torch.from_numpy(b_idx),
                torch.from_numpy(prio))
        np.testing.assert_array_equal(ts.priorities.numpy(),
                                      np.asarray(js.priorities))
        assert float(ts.max_priority) == float(js.max_priority)
    for n_step in (1, 3):
        np.testing.assert_array_equal(
            tpring._valid_start_mask(ts.ring, n_step).numpy(),
            np.asarray(jpring._valid_start_mask(js.ring, n_step)))
