"""Port parity: the host-DRAM time ring and its priority samplers
(dist_dqn_tpu_torch/replay/host_ring.py, the numpy half of
replay/host.py).

Both packages' modules are numpy, so the same chunk records (made from a
seed) go into the JAX package's ring and the port's, and everything that
comes out is held equal bit for bit: the stored window, uniform samples
at the same per-batch-index streams, prioritized draws, write-backs with
generation drops, and state_dict round trips.
"""
import numpy as np
import pytest

from dist_dqn_tpu.replay import host as jhost
from dist_dqn_tpu.replay import host_ring as jring
from dist_dqn_tpu_torch.replay import host as thost
from dist_dqn_tpu_torch.replay import host_ring as tring

from tests.test_frame_dedup import S, _rolling_stream

LANES, N_STEP, GAMMA = 3, 3, 0.97


def _batch_rng(seed: int, k: int) -> np.random.Generator:
    """The host-replay loop's per-batch-index stream (both packages)."""
    return np.random.default_rng(np.random.SeedSequence(seed,
                                                        spawn_key=(k,)))


def _both_rings(dedup: bool, slots: int):
    shape = (6, 5, 1) if dedup else (6, 5, S)
    stack = S if dedup else 0
    return (jring.HostTimeRing(slots, LANES, shape, np.uint8, stack),
            tring.HostTimeRing(slots, LANES, shape, np.uint8, stack))


def _feed(rings, steps: int, seed: int = 0, chunk: int = 40,
          dedup: bool = False):
    rng = np.random.default_rng(seed)
    obs, action, reward, term, trunc = _rolling_stream(rng, steps, LANES)
    stored = obs[..., -1:] if dedup else obs
    for lo in range(0, steps, chunk):
        hi = min(lo + chunk, steps)
        for r in rings:
            r.add_chunk(stored[lo:hi], action[lo:hi], reward[lo:hi],
                        term[lo:hi], trunc[lo:hi], birth_time=1.0 + lo,
                        params_version=lo)


def _assert_batches_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("steps,slots", [(40, 64), (200, 64)])
def test_host_ring_matches_jax(dedup, steps, slots):
    """The same chunks, wrapped (200 > 64) or not, deduped or not: the
    same stored window, and uniform samples at the same batch streams
    equal bit for bit (tolerance 0)."""
    jr, tr = _both_rings(dedup, slots)
    _feed((jr, tr), steps, dedup=dedup)
    for key in ("obs", "action", "reward", "terminated", "truncated",
                "slot_gen", "birth_time", "slot_version"):
        np.testing.assert_array_equal(getattr(tr, key), getattr(jr, key))
    assert (tr.pos, tr.size, tr.generation, tr.nbytes) == \
        (jr.pos, jr.size, jr.generation, jr.nbytes)
    assert tr.can_sample(N_STEP) == jr.can_sample(N_STEP)
    for k in range(4):
        js = jr.sample(_batch_rng(3, k), 32, N_STEP, GAMMA)
        ts = tr.sample(_batch_rng(3, k), 32, N_STEP, GAMMA)
        _assert_batches_equal(ts.batch, js.batch)
        np.testing.assert_array_equal(ts.t_idx, js.t_idx)
        np.testing.assert_array_equal(ts.b_idx, js.b_idx)
        assert ts.generation == js.generation


def test_host_ring_state_dict_round_trip():
    """A port snapshot restores into a fresh port ring and into a JAX ring
    (one format), and both sample as the original does."""
    jr, tr = _both_rings(True, 64)
    _feed((jr, tr), 150, dedup=True)
    state = tr.state_dict()
    for key, value in jr.state_dict().items():
        np.testing.assert_array_equal(state[key], value)
    fresh_t, fresh_j = _both_rings(True, 64)
    fresh_t.load_state_dict(state)
    fresh_j.load_state_dict(state)
    for r in (fresh_t, fresh_j):
        got = r.sample(_batch_rng(0, 9), 16, N_STEP, GAMMA)
        want = tr.sample(_batch_rng(0, 9), 16, N_STEP, GAMMA)
        _assert_batches_equal(got.batch, want.batch)
    with pytest.raises(ValueError, match="different replay/env config"):
        _both_rings(False, 64)[1].load_state_dict(state)


def test_np_n_step_matches_jax():
    rng = np.random.default_rng(4)
    reward = rng.normal(size=(50, 5)).astype(np.float32)
    term = rng.uniform(size=(50, 5)) < 0.1
    trunc = rng.uniform(size=(50, 5)) < 0.1
    for got, want in zip(tring._np_n_step(reward, term, trunc, 0.99),
                         jring._np_n_step(reward, term, trunc, 0.99)):
        np.testing.assert_array_equal(got, want)


def test_sum_tree_and_stratified_mass_match_jax():
    rng = np.random.default_rng(5)
    jt, tt = jhost.SumTree(1000), thost.SumTree(1000)
    for _ in range(5):
        idx = rng.integers(0, 1000, 300)
        vals = rng.uniform(0.0, 2.0, 300)
        jt.set(idx, vals)
        tt.set(idx, vals)
    np.testing.assert_array_equal(tt.tree, jt.tree)
    mass = thost.stratified_mass(np.random.default_rng(1), 64, tt.total)
    np.testing.assert_array_equal(
        mass, jhost.stratified_mass(np.random.default_rng(1), 64, jt.total))
    np.testing.assert_array_equal(tt.sample(mass), jt.sample(mass))
    for bad in ([-1], [1024]):
        with pytest.raises(IndexError):
            tt.get(np.array(bad))
    assert isinstance(thost.make_sum_tree(10), thost.NativeSumTree)
    assert isinstance(thost.make_sum_tree(10, native=True),
                      thost.NativeSumTree)
    assert isinstance(thost.make_sum_tree(10, native=False), thost.SumTree)


def _both_samplers(device_plane: bool, dedup: bool = False):
    jr, tr = _both_rings(dedup, 64)
    if device_plane:
        js = jring.RingDevicePrioritySampler(jr, N_STEP, seed=0)
        ts = tring.RingDevicePrioritySampler(tr, N_STEP, device="cpu")
    else:
        # The numpy tree on both sides (JAX's C++ tree does not compile
        # with g++ 12; the port's agrees with numpy to rtol 1e-12 only).
        js = jring.RingPrioritySampler(jr, N_STEP, native=False)
        ts = tring.RingPrioritySampler(tr, N_STEP, native=False)
    return (jr, js), (tr, ts)


def _per_round(samplers, k: int):
    """One draw per sampler at batch stream k, then a write-back of
    |TD| made from k (the same for both)."""
    out = []
    for s in samplers:
        batch, per = s.sample(_batch_rng(1, k), 24, GAMMA)
        out.append((batch, per))
    rng = np.random.default_rng(100 + k)
    prios = rng.uniform(0.0, 3.0, 24)
    counts = [s.update_priorities(per.leaf, prios, per.slot_gen)
              for s, (_, per) in zip(samplers, out)]
    return out, counts


@pytest.mark.parametrize("device_plane", [False, True],
                         ids=["sum_tree", "device_plane"])
@pytest.mark.parametrize("dedup", [False, True])
def test_ring_priority_sampler_matches_jax(device_plane, dedup):
    """Draws, IS weights, write-backs, generation drops and state_dict
    round trips of the port's ring PER samplers equal the JAX package's
    bit for bit, with the sum-tree and with the device plane (the plane on
    the CPU draws through the three-level torch draw, the JAX plane
    through its XLA twin)."""
    (jr, js), (tr, ts) = _both_samplers(device_plane, dedup)
    rng = np.random.default_rng(0)
    obs, action, reward, term, trunc = _rolling_stream(rng, 400, LANES)
    stored = obs[..., -1:] if dedup else obs
    pos = 0
    for k in range(12):
        for r in (jr, tr):
            r.add_chunk(stored[pos:pos + 20], action[pos:pos + 20],
                        reward[pos:pos + 20], term[pos:pos + 20],
                        trunc[pos:pos + 20])
        pos += 20
        if not tr.can_sample(N_STEP):
            continue
        (jout, tout), counts = _per_round((js, ts), k)
        assert counts[0] == counts[1]
        _assert_batches_equal(tout[0], jout[0])
        for field in ("leaf", "t_idx", "b_idx", "slot_gen", "weights"):
            np.testing.assert_array_equal(getattr(tout[1], field),
                                          getattr(jout[1], field))
        assert ts._backend_total() == js._backend_total()
        if k == 5:
            # A write-back whose slots were overwritten since the draw is
            # dropped in both.
            _, per = ts.sample(_batch_rng(2, k), 24, GAMMA)
            _, jper = js.sample(_batch_rng(2, k), 24, GAMMA)
            for r in (jr, tr):
                r.add_chunk(stored[pos:pos + 60], action[pos:pos + 60],
                            reward[pos:pos + 60], term[pos:pos + 60],
                            trunc[pos:pos + 60])
            pos += 60
            got = ts.update_priorities(per.leaf, np.ones(24), per.slot_gen)
            want = js.update_priorities(jper.leaf, np.ones(24),
                                        jper.slot_gen)
            assert got == want and got[1] > 0
    assert (ts.writeback_flushes, ts.writeback_rows,
            ts.writeback_dropped) == (js.writeback_flushes,
                                      js.writeback_rows,
                                      js.writeback_dropped)
    state = ts.state_dict()
    jstate = js.state_dict()
    assert set(state) == set(jstate)
    for key in state:
        np.testing.assert_array_equal(state[key], jstate[key])
    # Round trip: a fresh sampler over a restored ring draws as the
    # original does.
    (_, _), (tr2, ts2) = _both_samplers(device_plane, dedup)
    tr2.load_state_dict(tr.state_dict())
    ts2.load_state_dict(state)
    (a, _), (b, _) = (ts.sample(_batch_rng(5, 0), 24, GAMMA),
                      ts2.sample(_batch_rng(5, 0), 24, GAMMA))
    _assert_batches_equal(a, b)
    bad = dict(state, alpha=np.float64(0.5))
    with pytest.raises(ValueError, match="replay.priority_exponent"):
        ts2.load_state_dict(bad)
