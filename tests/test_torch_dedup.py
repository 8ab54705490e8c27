"""Port parity: frame-dedup rings (replay.frame_dedup) against the JAX
package, exactly.

Both packages' rings take the same numpy stream of rolling frame stacks
(random frames, resets inside stack contexts, rings wrapped), store only
each step's newest frame, and are gathered at the same (t, b): rebuilt
stacks, n-step fields, start regions and the rebuild's slot indices must
be bit-identical (uint8 frames, f32 returns: tolerance none). Inside the
port, dedup storage must also equal stacked storage.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.replay import device as jring
from dist_dqn_tpu.replay import prioritized_device as jpring
from dist_dqn_tpu.replay import sequence_device as jsring
from dist_dqn_tpu_torch.replay import device as tring
from dist_dqn_tpu_torch.replay import prioritized_device as tpring
from dist_dqn_tpu_torch.replay import sequence_device as tsring

H, W, S = 6, 5, 4
LANES, N_STEP = 3, 3


def _rolling_stream(seed, steps, lanes=LANES):
    """(obs [steps, lanes, H, W, S], action, reward, term, trunc) obeying
    the rolling-stack contract: obs shifts one frame per step and a done
    at t re-tiles obs_{t+1} with its first frame."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (steps + 1, lanes, H, W), np.uint8)
    done = rng.random((steps, lanes)) < 0.25
    term = done & (rng.random((steps, lanes)) < 0.5)
    trunc = done & ~term
    obs = np.zeros((steps, lanes, H, W, S), np.uint8)
    cur = np.repeat(frames[0][..., None], S, axis=-1)
    for t in range(steps):
        obs[t] = cur
        shifted = np.concatenate([cur[..., 1:], frames[t + 1][..., None]], -1)
        tiled = np.repeat(frames[t + 1][..., None], S, axis=-1)
        cur = np.where(done[t][:, None, None, None], tiled, shifted)
    action = rng.integers(0, 6, (steps, lanes)).astype(np.int32)
    reward = rng.normal(size=(steps, lanes)).astype(np.float32)
    return obs, action, reward, term, trunc


def _stored(obs_t, dedup, merge):
    o = obs_t[..., -1:] if dedup else obs_t
    return o.reshape(o.shape[0], -1) if merge else o


def _example(dedup, merge):
    shape = (H, W, 1 if dedup else S)
    return np.zeros((int(np.prod(shape)),) if merge else shape, np.uint8)


def _fill_both(stream, slots, merge, prioritized=False):
    """A JAX and a port dedup ring (PER rings with ``prioritized``)."""
    obs, action, reward, term, trunc = stream
    ex = _example(True, merge)
    if prioritized:
        js = jpring.prioritized_ring_init(slots, LANES, jnp.asarray(ex),
                                          merge_obs_rows=merge)
        ts = tpring.prioritized_ring_init(slots, LANES, torch.from_numpy(ex),
                                          merge_obs_rows=merge)
        jadd, tadd = jpring.prioritized_ring_add, tpring.prioritized_ring_add
    else:
        js = jring.time_ring_init(slots, LANES, jnp.asarray(ex),
                                  merge_obs_rows=merge)
        ts = tring.time_ring_init(slots, LANES, torch.from_numpy(ex),
                                  merge_obs_rows=merge)
        jadd, tadd = jring.time_ring_add, tring.time_ring_add
    for t in range(obs.shape[0]):
        o = _stored(obs[t], True, merge)
        js = jadd(js, jnp.asarray(o), jnp.asarray(action[t]),
                  jnp.asarray(reward[t]), jnp.asarray(term[t]),
                  jnp.asarray(trunc[t]), merge_obs_rows=merge)
        tadd(ts, torch.from_numpy(o), torch.from_numpy(action[t]),
             torch.from_numpy(reward[t]), torch.from_numpy(term[t]),
             torch.from_numpy(trunc[t]), merge_obs_rows=merge)
    return js, ts


def _valid_starts(steps, slots, extra, tail):
    """Every (t, b) whose context and window are stored."""
    size = min(steps, slots)
    offsets = np.arange(extra, size - tail)
    oldest = (steps - size) % slots
    t_idx = np.repeat((oldest + offsets) % slots, LANES).astype(np.int32)
    b_idx = np.tile(np.arange(LANES), len(offsets)).astype(np.int32)
    return t_idx, b_idx


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("steps,slots", [(40, 64), (200, 64)])
def test_dedup_gather_matches_jax_and_stacked(merge, steps, slots):
    stream = _rolling_stream(0, steps)
    js, ts = _fill_both(stream, slots, merge)
    t_idx, b_idx = _valid_starts(steps, slots, S - 1, N_STEP)
    frame = (H, W, 1)
    want = jring.gather_transitions(js, jnp.asarray(t_idx),
                                    jnp.asarray(b_idx), N_STEP, 0.97,
                                    merge_obs_rows=merge, frame_stack=S,
                                    frame_shape=frame)
    got = tring.gather_transitions(ts, torch.from_numpy(t_idx),
                                   torch.from_numpy(b_idx), N_STEP, 0.97,
                                   merge_obs_rows=merge, frame_stack=S,
                                   frame_shape=frame)
    for field in ("obs", "action", "reward", "discount", "next_obs"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.obs.shape == (len(t_idx), H, W, S)
    # The stream has resets inside stack contexts.
    assert (np.asarray(want.discount) == 0).any()

    # Inside the port: the same gather from a ring of whole stacks.
    obs, action, reward, term, trunc = stream
    full = tring.time_ring_init(slots, LANES,
                                torch.from_numpy(_example(False, merge)),
                                merge_obs_rows=merge)
    for t in range(steps):
        tring.time_ring_add(
            full, torch.from_numpy(_stored(obs[t], False, merge)),
            torch.from_numpy(action[t]), torch.from_numpy(reward[t]),
            torch.from_numpy(term[t]), torch.from_numpy(trunc[t]),
            merge_obs_rows=merge)
    stacked = tring.gather_transitions(full, torch.from_numpy(t_idx),
                                       torch.from_numpy(b_idx), N_STEP, 0.97,
                                       merge_obs_rows=merge)
    for field in ("obs", "next_obs"):
        np.testing.assert_array_equal(
            getattr(stacked, field).reshape(-1, H, W, S).numpy(),
            getattr(got, field).numpy(), err_msg=field)


def test_stack_rebuild_indices_match_jax():
    rng = np.random.default_rng(4)
    T, n = 16, 64
    done = rng.random(T) < 0.3
    t_idx = rng.integers(0, T, n).astype(np.int32)
    want = jring.stack_rebuild_indices(
        lambda tt: jnp.asarray(done)[tt], jnp.asarray(t_idx), S, T)
    got = tring.stack_rebuild_indices(
        lambda tt: torch.from_numpy(done)[tt], torch.from_numpy(t_idx).long(),
        S, T)
    assert [d for d, _ in got] == [d for d, _ in want] == list(range(S))
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("steps", [20, 150])
def test_dedup_start_regions_match_jax(steps):
    """Uniform: the contextful start mask and the can-sample gate; PER:
    _valid_start_mask(frame_stack=4); and the PER draw at shared uniforms
    returns the same rebuilt batch."""
    slots = 32
    stream = _rolling_stream(1, steps)
    jp, tp = _fill_both(stream, slots, merge=True, prioritized=True)
    for fs in (0, S):
        np.testing.assert_array_equal(
            tring.contextful_start_mask(tp.ring, fs).numpy(),
            np.asarray(jring.contextful_start_mask(jp.ring, fs)))
        for n_step in (1, N_STEP):
            np.testing.assert_array_equal(
                tpring._valid_start_mask(tp.ring, n_step, fs).numpy(),
                np.asarray(jpring._valid_start_mask(jp.ring, n_step,
                                                    frame_stack=fs)))
            assert tring.time_ring_can_sample(tp.ring, n_step, fs) == bool(
                jring.time_ring_can_sample(jp.ring, n_step, frame_stack=fs))
    mask = tpring._valid_start_mask(tp.ring, N_STEP, S).numpy()
    assert mask.sum() == min(steps, slots) - N_STEP - (S - 1)

    import jax
    key = jax.random.PRNGKey(2)
    batch = 16
    u01 = np.array((jnp.arange(batch, dtype=jnp.float32)
                    + jax.random.uniform(key, (batch,))) / batch)
    js = jpring.prioritized_ring_sample(
        jp, key, batch, N_STEP, 0.97, 0.6, jnp.float32(0.4),
        merge_obs_rows=True, frame_stack=S, frame_shape=(H, W, 1))
    ts = tpring.prioritized_ring_sample(
        tp, None, batch, N_STEP, 0.97, 0.6, 0.4, merge_obs_rows=True,
        u=torch.from_numpy(u01), frame_stack=S, frame_shape=(H, W, 1))
    np.testing.assert_array_equal(ts.t_idx.numpy(), np.asarray(js.t_idx))
    np.testing.assert_array_equal(ts.b_idx.numpy(), np.asarray(js.b_idx))
    np.testing.assert_array_equal(ts.batch.obs.numpy(),
                                  np.asarray(js.batch.obs))
    np.testing.assert_array_equal(ts.batch.next_obs.numpy(),
                                  np.asarray(js.batch.next_obs))
    assert bool((ts.t_idx.numpy()[:, None] != np.nonzero(~mask)[0]).all())


def test_uniform_dedup_sample_stays_in_contextful_region(monkeypatch):
    """time_ring_sample with frame_stack draws every start whose context
    and window are stored, and no other."""
    steps, slots, n_step = 20, 32, 2
    _, ts = _fill_both(_rolling_stream(5, steps), slots, merge=False)
    drawn = []
    gather = tring.gather_transitions

    def spy(state, t_idx, *args, **kwargs):
        drawn.extend(t_idx.tolist())
        return gather(state, t_idx, *args, **kwargs)

    monkeypatch.setattr(tring, "gather_transitions", spy)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        batch = tring.time_ring_sample(ts, gen, 64, n_step, 0.97,
                                       frame_stack=S, frame_shape=(H, W, 1))
        assert tuple(batch.obs.shape) == (64, H, W, S)
    # 20 steps stored at slots 0..19: the dedup starts are 3..17.
    assert set(drawn) == set(range(S - 1, steps - n_step))


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("steps", [30, 150])   # unwrapped / wrapped (64 slots)
def test_sequence_dedup_rebuild_matches_jax(merge, steps):
    """_rebuild_seq_stacks: [L, S_] windows of rebuilt stacks equal JAX's,
    bit for bit, and equal windows gathered from a stacked sequence ring."""
    slots, L = 64, 6
    obs, action, reward, term, trunc = _rolling_stream(3, steps)
    carry = np.zeros((LANES, 4), np.float32)

    def fill(dedup):
        ex = _example(dedup, merge)
        js = jsring.sequence_ring_init(slots, LANES, jnp.asarray(ex), 4,
                                       merge_obs_rows=merge)
        ts = tsring.sequence_ring_init(slots, LANES, torch.from_numpy(ex), 4,
                                       merge_obs_rows=merge)
        for t in range(steps):
            o = _stored(obs[t], dedup, merge)
            js = jsring.sequence_ring_add(
                js, jnp.asarray(o), jnp.asarray(action[t]),
                jnp.asarray(reward[t]), jnp.asarray(term[t]),
                jnp.asarray(trunc[t]), (jnp.asarray(carry),) * 2, L, 3,
                merge_obs_rows=merge)
            tsring.sequence_ring_add(
                ts, torch.from_numpy(o), torch.from_numpy(action[t]),
                torch.from_numpy(reward[t]), torch.from_numpy(term[t]),
                torch.from_numpy(trunc[t]), (torch.from_numpy(carry),) * 2,
                L, 3, merge_obs_rows=merge)
        return js, ts

    (jd, td), (_, tfull) = fill(True), fill(False)
    t_idx, b_idx = _valid_starts(steps, slots, S - 1, L)
    want = jsring._rebuild_seq_stacks(jd.ring, jnp.asarray(t_idx),
                                      jnp.asarray(b_idx), L, S, merge,
                                      (H, W, 1))
    got = tsring._rebuild_seq_stacks(td.ring, torch.from_numpy(t_idx),
                                     torch.from_numpy(b_idx), L, S, merge,
                                     (H, W, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(got.shape) == (L, len(t_idx), H, W, S)
    tt = (torch.from_numpy(t_idx).long()[None, :]
          + torch.arange(L)[:, None]) % slots
    b = torch.from_numpy(b_idx).long()[None, :]
    stacked = (tfull.ring.obs[tt * LANES + b] if merge
               else tfull.ring.obs[tt, b]).reshape(got.shape)
    np.testing.assert_array_equal(got.numpy(), stacked.numpy())


@pytest.mark.parametrize("steps", [30, 150])
def test_sequence_dedup_sample_matches_jax(steps):
    """sequence_ring_sample with frame_stack at shared uniforms: the draw
    skips the contextless oldest starts and the rebuilt windows, weights
    and indices equal JAX's."""
    import jax

    slots, L = 64, 6
    obs, action, reward, term, trunc = _rolling_stream(6, steps)
    carry = np.zeros((LANES, 4), np.float32)
    ex = _example(True, True)
    js = jsring.sequence_ring_init(slots, LANES, jnp.asarray(ex), 4,
                                   merge_obs_rows=True)
    ts = tsring.sequence_ring_init(slots, LANES, torch.from_numpy(ex), 4,
                                   merge_obs_rows=True)
    for t in range(steps):
        o = _stored(obs[t], True, True)
        js = jsring.sequence_ring_add(
            js, jnp.asarray(o), jnp.asarray(action[t]),
            jnp.asarray(reward[t]), jnp.asarray(term[t]),
            jnp.asarray(trunc[t]), (jnp.asarray(carry),) * 2, L, 1,
            merge_obs_rows=True)
        tsring.sequence_ring_add(
            ts, torch.from_numpy(o), torch.from_numpy(action[t]),
            torch.from_numpy(reward[t]), torch.from_numpy(term[t]),
            torch.from_numpy(trunc[t]), (torch.from_numpy(carry),) * 2,
            L, 1, merge_obs_rows=True)
    key = jax.random.PRNGKey(7)
    batch = 16
    u01 = np.array((jnp.arange(batch, dtype=jnp.float32)
                    + jax.random.uniform(key, (batch,))) / batch)
    want = jsring.sequence_ring_sample(js, key, batch, L, 0.9,
                                       jnp.float32(0.6), merge_obs_rows=True,
                                       frame_stack=S, frame_shape=(H, W, 1))
    got = tsring.sequence_ring_sample(ts, None, batch, L, 0.9, 0.6,
                                      merge_obs_rows=True,
                                      u=torch.from_numpy(u01), frame_stack=S,
                                      frame_shape=(H, W, 1))
    for field in ("t_idx", "b_idx", "obs", "action", "reward", "done",
                  "reset"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-6)
    oldest = (ts.ring.pos - ts.ring.size) % slots
    offsets = (got.t_idx.numpy() - oldest) % slots
    assert (offsets >= S - 1).all()
    # The host predicate counts exactly the drawable starts.
    live = tsring.live_start_writes(ts.writes, slots, L, 1, frame_stack=S)
    drawable = (ts.priorities > 0) & tring.contextful_start_mask(
        ts.ring, S)[:, None]
    assert sorted(s % slots for s in live) == \
        drawable.any(dim=1).nonzero()[:, 0].tolist()
