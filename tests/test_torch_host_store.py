"""Port parity of the Ape-X service's stores (dist_dqn_tpu_torch/replay/
host.py ``PrioritizedHostReplay``, ``UniformHostReplay`` and
``DevicePrioritySampler.sample``) against the JAX package's.

* Tree mode (both numpy): a seeded add / sample / update sequence with a
  wrapping ring, deferred write-backs and the generation guard gives the
  same items, indices, IS weights, generations and counters, bit for bit.
* Device mode on the CPU (the plane's three-level torch draw): the store's
  ``sample_at`` equals the JAX store's at explicit uniforms; ``sample``
  draws from the plane's own generator, not JAX's key stream, so it is
  held statistically (pick frequencies against p ** alpha within 5
  standard errors, and the IS weight formula at its picks, rtol 1e-6); a
  pick past ``size`` is clamped to ``size - 1`` with its weight zeroed.
* ``state_dict`` round trips, and the uniform store follows JAX's.
"""
import numpy as np
import pytest

from dist_dqn_tpu.replay import host as jhost
from dist_dqn_tpu_torch.replay import host as thost


def _items(rng, n, start):
    return {"obs": rng.integers(0, 255, (n, 6, 6, 2)).astype(np.uint8),
            "action": rng.integers(0, 4, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "discount": np.full(n, 0.97, np.float32),
            "id": np.arange(start, start + n, dtype=np.int64)}


def _pair(capacity, sampler="tree", **kw):
    # The numpy tree on both sides: JAX's C++ tree does not compile with
    # g++ 12, and the port's C++ tree agrees with numpy only to rtol 1e-12
    # in totals (tests/test_torch_native_sumtree.py).
    jkw = dict(native=False) if sampler == "tree" else {}
    ours = thost.PrioritizedHostReplay(capacity, alpha=0.6, seed=3,
                                       sampler=sampler, sampler_device="cpu",
                                       **jkw, **kw)
    theirs = jhost.PrioritizedHostReplay(capacity, alpha=0.6, seed=3,
                                         sampler=sampler, **jkw)
    if sampler == "device":
        # The JAX plane on the CPU draws through its XLA three-level path.
        theirs.device_sampler = jhost.DevicePrioritySampler(
            capacity, seed=3, use_pallas=False)
    return ours, theirs


def test_tree_store_follows_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    ours, theirs = _pair(700)
    pending = []
    start = 0
    for step in range(40):
        n = int(rng.integers(20, 60))
        items = _items(rng, n, start)
        start += n
        prios = (None if step % 5 == 0
                 else np.abs(rng.normal(size=n)) * 3)
        for store in (ours, theirs):
            store.add(items, priorities=prios, shard=0)
        if len(ours) < 64:
            continue
        beta = 0.4 + 0.01 * step
        got = ours.sample(64, beta)
        want = theirs.sample(64, beta)
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].dtype == np.float32
        gen = ours.generation(got[1])
        np.testing.assert_array_equal(gen, theirs.generation(want[1]))
        pending.append((got[1], np.abs(rng.normal(size=64)), gen))
        if len(pending) == 3:      # deferred, batched write-backs
            idx = np.concatenate([p[0] for p in pending])
            p = np.concatenate([p[1] for p in pending])
            g = np.concatenate([p[2] for p in pending])
            for store in (ours, theirs):
                store.update_priorities(idx, p, expected_gen=g)
            pending = []
    assert ours.added == theirs.added and ours.sampled == theirs.sampled
    assert ours.added_by_shard == theirs.added_by_shard == {0: ours.added}
    assert ours._max_priority == theirs._max_priority
    np.testing.assert_array_equal(ours.tree.tree, theirs.tree.tree)
    assert len(ours) == len(theirs) == 700


def test_generation_guard_drops_overwritten_slots():
    rng = np.random.default_rng(1)
    store = thost.PrioritizedHostReplay(8, alpha=1.0, priority_eps=0.0)
    store.add(_items(rng, 8, 0), priorities=np.ones(8))
    idx = np.arange(8)
    gen = store.generation(idx)
    store.add(_items(rng, 3, 8), priorities=np.ones(3))   # slots 0..2 anew
    store.update_priorities(idx, np.full(8, 5.0), expected_gen=gen)
    np.testing.assert_array_equal(store.tree.get(idx),
                                  [1, 1, 1, 5, 5, 5, 5, 5])
    store.update_priorities(idx[:3], np.full(3, 2.0),
                            expected_gen=gen[:3])     # all stale: no-op
    np.testing.assert_array_equal(store.tree.get(idx[:3]), [1, 1, 1])


def test_device_store_sample_at_equals_jax():
    rng = np.random.default_rng(2)
    ours, theirs = _pair(3000, sampler="device")
    assert not ours.device_sampler.use_kernel
    for step in range(6):
        items = _items(rng, 400, step * 400)
        prios = np.abs(rng.normal(size=400)) + 0.1
        for store in (ours, theirs):
            store.add(items, priorities=prios)
        u = ((np.arange(64) + rng.uniform(size=64)) / 64).astype(np.float32)
        got = ours.device_sampler.sample_at(u, len(ours))
        want = theirs.device_sampler.sample_at(u, len(theirs))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert ours.device_sampler.total == theirs.device_sampler.total


def test_device_store_sample_is_the_stratified_per_draw():
    """Pick frequencies against p ** alpha / sum within 5 standard errors,
    weights ``(N P(i)) ** -beta / max`` at the picks, one plane draw per
    call counted in ``draw_dispatches``."""
    rng = np.random.default_rng(5)
    n = 40
    store = thost.PrioritizedHostReplay(1000, alpha=0.6, priority_eps=0.0,
                                        sampler="device",
                                        sampler_device="cpu", seed=11)
    prios = rng.uniform(0.05, 4.0, n)
    store.add(_items(rng, n, 0), priorities=prios)
    mass = prios ** 0.6
    p = mass / mass.sum()
    counts = np.zeros(n)
    draws, S, beta = 400, 32, 0.5
    for _ in range(draws):
        items, idx, w = store.sample(S, beta)
        assert (idx < n).all() and w.dtype == np.float32
        np.testing.assert_array_equal(items["id"], idx)
        want_w = (n * p[idx]) ** -beta
        np.testing.assert_allclose(w, want_w / want_w.max(), rtol=1e-5)
        counts += np.bincount(idx, minlength=n)
    total = draws * S
    se = np.sqrt(total * p * (1 - p))
    assert (np.abs(counts - total * p) < 5 * se + 1).all()
    assert store.device_sampler.draw_dispatches == draws
    # The generator is the plane's own: the same seed draws the same.
    again = thost.PrioritizedHostReplay(1000, alpha=0.6, priority_eps=0.0,
                                        sampler="device",
                                        sampler_device="cpu", seed=11)
    again.add(_items(np.random.default_rng(5), n, 0), priorities=prios)
    first = thost.PrioritizedHostReplay(1000, alpha=0.6, priority_eps=0.0,
                                        sampler="device",
                                        sampler_device="cpu", seed=11)
    first.add(_items(np.random.default_rng(5), n, 0), priorities=prios)
    np.testing.assert_array_equal(again.sample(S, beta)[1],
                                  first.sample(S, beta)[1])


def test_device_store_clamps_and_zeroes_picks_past_size():
    store = thost.PrioritizedHostReplay(1024, alpha=1.0, priority_eps=0.0,
                                        sampler="device",
                                        sampler_device="cpu")
    store.add(_items(np.random.default_rng(6), 10, 0),
              priorities=np.ones(10))
    # Mass on a slot past the written region (as a boundary pathology
    # would leave it): draws landing there come back as slot size - 1
    # with weight 0.
    store.device_sampler.set(np.array([500]), np.array([1000.0]))
    items, idx, w = store.sample(64, 0.4)
    oob = w == 0.0
    assert oob.sum() > 50 and (idx[oob] == 9).all() and (idx < 10).all()
    assert (w[~oob] > 0).all()


@pytest.mark.parametrize("sampler", ["tree", "device"])
def test_state_dict_round_trips(sampler):
    rng = np.random.default_rng(7)
    a = thost.PrioritizedHostReplay(300, sampler=sampler,
                                    sampler_device="cpu")
    a.add(_items(rng, 350, 0), priorities=np.abs(rng.normal(size=350)))
    state = a.state_dict()
    b = thost.PrioritizedHostReplay(300, sampler=sampler,
                                    sampler_device="cpu")
    b.load_state_dict(state)
    assert (len(b), b.added, b._pos) == (len(a), a.added, a._pos)
    np.testing.assert_array_equal(b.generation(np.arange(300)),
                                  a.generation(np.arange(300)))
    np.testing.assert_array_equal(b.state_dict()["mass"], state["mass"])
    for k, v in a._data.items():
        np.testing.assert_array_equal(b._data[k], v)
    with pytest.raises(ValueError, match="capacity"):
        thost.PrioritizedHostReplay(301, sampler=sampler,
                                    sampler_device="cpu"
                                    ).load_state_dict(state)
    with pytest.raises(ValueError, match="unallocated"):
        thost.PrioritizedHostReplay(8).state_dict()


def test_uniform_store_follows_jax():
    rng = np.random.default_rng(8)
    ours = thost.UniformHostReplay(100, seed=4)
    theirs = jhost.UniformHostReplay(100, seed=4)
    for step in range(6):
        items = _items(rng, 30, step * 30)
        ours.add(items)
        theirs.add(items)
        got, want = ours.sample(16), theirs.sample(16)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert len(ours) == len(theirs) == 100
    state = ours.state_dict()
    back = thost.UniformHostReplay(100)
    back.load_state_dict(state)
    np.testing.assert_array_equal(back._data["id"], ours._data["id"])
