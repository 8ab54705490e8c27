"""The port's sharded host stores (dist_dqn_tpu_torch/replay/sharded.py)
against the JAX package's ``dist_dqn_tpu/replay/sharded.py``, and the twins
of JAX's own pins (``tests/test_sharded_replay.py`` and
``tests/test_device_sharded_sampling.py``).

Both packages are fed the same records and draw at the same numpy
generator, with the numpy sum-tree on both sides (``native=False``: the
JAX package's C++ tree does not build here, and the native tree agrees
with numpy only to rounding in its totals). Their ``state_dict`` arrays
and draws (slot ids, IS weights, gathered rows) are equal bit for bit,
apart from the rings' ``birth_time`` wall-clock stamps; so are the 2 -> 4,
2 -> 1 and 1 -> 2 migrations. The device planes run on the CPU here (the
card's kernel is held to them by chip_smoke.py).
"""
import threading

import numpy as np
import pytest

from dist_dqn_tpu.replay import host as jhost
from dist_dqn_tpu.replay import sharded as jsharded
from dist_dqn_tpu_torch.ingest.router import shard_for
from dist_dqn_tpu_torch.replay import host as thost
from dist_dqn_tpu_torch.replay import host_ring as tring
from dist_dqn_tpu_torch.replay import sharded as tsharded


def _fill(store, shard, rng, chunks=3, C=24):
    """``chunks`` random [C, lanes] chunks into one shard of a facade (or a
    bare ring)."""
    rings = getattr(store, "rings", None)
    lanes = rings[shard].num_envs if rings else store.num_envs
    for _ in range(chunks):
        args = (rng.random((C, lanes, 5), np.float32),
                rng.integers(0, 4, (C, lanes)).astype(np.int32),
                rng.random((C, lanes)).astype(np.float32),
                rng.random((C, lanes)) < 0.05, np.zeros((C, lanes), bool))
        if rings:
            store.add_chunk(shard, *args)
        else:
            store.add_chunk(*args)


def _facades(shards, slots, lanes, fill_seed, chunks=3, C=24, **per):
    """The same filled facade in both packages (numpy trees)."""
    out = []
    for mod in (jsharded, tsharded):
        fac = mod.ShardedHostReplay(shards, slots, lanes, (5,), np.float32)
        if per:
            fac.attach_priority_samplers(native=False, **per)
        for s in range(shards):
            _fill(fac, s, np.random.default_rng(fill_seed + s),
                  chunks=chunks, C=C)
        out.append(fac)
    return out


def _assert_states_equal(want, got):
    assert set(want) == set(got)
    for k, v in want.items():
        if not k.endswith("birth_time"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _assert_draws_equal(want, got):
    (jb, jp), (tb, tp) = want, got
    for field in ("leaf", "t_idx", "b_idx", "slot_gen", "weights"):
        np.testing.assert_array_equal(getattr(tp, field),
                                      getattr(jp, field), err_msg=field)
    assert tp.generation == jp.generation
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b, a)


# --------------------------------------------------------------------------
# ShardedHostReplay (JAX :79-376).
# --------------------------------------------------------------------------

def test_one_shard_facade_bit_identical_to_bare_ring():
    """Twin of test_sharded_replay.py:52: one shard delegates to the bare
    ring's sampler (draws, weights, write-backs), and equals JAX's
    facade."""
    ring = tring.HostTimeRing(64, 8, (5,), np.float32)
    _fill(ring, 0, np.random.default_rng(11))
    bare = tring.RingPrioritySampler(ring, n_step=3, native=False)
    jfac, tfac = _facades(1, 64, 8, 11, n_step=3, alpha=0.6, beta=0.4,
                          eps=1e-6)
    b1 = bare.sample(np.random.default_rng(7), 32, 0.99)
    b2 = tfac.sample(np.random.default_rng(7), 32, 0.99)
    _assert_draws_equal(b1, b2)
    _assert_draws_equal(jfac.sample(np.random.default_rng(7), 32, 0.99), b2)
    prios = np.random.default_rng(3).random(32)
    per = b2[1]
    r1 = bare.update_priorities(per.leaf, prios, expected_gen=per.slot_gen)
    assert tfac.update_priorities(per.leaf, prios, per.slot_gen) == r1
    assert jfac.update_priorities(per.leaf, prios, per.slot_gen) == r1
    assert bare.tree.total == tfac.samplers[0].tree.total == \
        jfac.samplers[0].tree.total


def test_cross_shard_draws_proportional_to_tree_mass():
    """Twin of test_sharded_replay.py:80: draws land in each shard in
    proportion to its tree mass (shard 1 carries 4x shard 0's)."""
    jfac, tfac = _facades(2, 256, 4, 20, chunks=4, C=48, n_step=1,
                          alpha=1.0, beta=0.4, eps=1e-6)
    for fac in (jfac, tfac):
        for s, p in ((0, 1.0), (1, 4.0)):
            ring = fac.rings[s]
            leaf = np.arange(ring.num_slots * ring.num_envs, dtype=np.int64)
            fac.samplers[s].update_priorities(
                leaf, np.full(leaf.shape[0], p),
                expected_gen=ring.slot_gen[leaf // ring.num_envs])
    totals = np.array([s.tree.total for s in tfac.samplers])
    counts = np.zeros(2)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(200):
        got = tfac.sample(rng, 64, 0.99)
        _assert_draws_equal(jfac.sample(jrng, 64, 0.99), got)
        counts += np.bincount(got[1].leaf // tfac.leaf_stride, minlength=2)
    np.testing.assert_allclose(counts / counts.sum(),
                               totals / totals.sum(), atol=0.03)


def test_cross_shard_is_weights_match_bruteforce():
    """Twin of test_sharded_replay.py:107: the facade's weights are
    ``(N_valid_global * P(i)) ** -beta`` from the global total,
    normalized over the batch, and equal JAX's."""
    jfac, tfac = _facades(2, 128, 4, 30, chunks=3, C=32, n_step=2,
                          alpha=0.6, beta=0.5, eps=1e-6)
    for fac in (jfac, tfac):
        rng = np.random.default_rng(9)
        for s in (0, 1):
            ring = fac.rings[s]
            leaf = np.arange(ring.num_slots * ring.num_envs, dtype=np.int64)
            fac.samplers[s].update_priorities(
                leaf, rng.random(leaf.shape[0]) * (1 + 3 * s),
                expected_gen=ring.slot_gen[leaf // ring.num_envs])
    batch, per = tfac.sample(np.random.default_rng(4), 64, 0.99)
    _assert_draws_equal(jfac.sample(np.random.default_rng(4), 64, 0.99),
                        (batch, per))
    samplers = tfac.samplers
    T = sum(s.tree.total for s in samplers)
    n_valid = sum((r.size - s.n_step - r._extra()) * r.num_envs
                  for r, s in zip(tfac.rings, samplers))
    mass = np.array([samplers[int(lf // tfac.leaf_stride)].tree.get(
        np.array([lf % tfac.leaf_stride]))[0] for lf in per.leaf])
    w = (n_valid * np.maximum(mass / T, 1e-12)) ** (-0.5)
    np.testing.assert_allclose(per.weights, (w / w.max()).astype(np.float32),
                               rtol=1e-6)


def test_writebacks_route_to_owning_shard_with_generation_guard():
    """Twin of test_sharded_replay.py:138: global slot ids route to their
    shard's tree; a stale generation drops every row."""
    jfac, tfac = _facades(2, 64, 4, 40, n_step=1, alpha=1.0, beta=0.4,
                          eps=1e-6)
    _, per = tfac.sample(np.random.default_rng(2), 32, 0.99)
    before = [s.tree.total for s in tfac.samplers]
    for fac in (jfac, tfac):
        assert fac.update_priorities(per.leaf, np.full(32, 9.0),
                                     per.slot_gen) == (32, 0)
        assert fac.update_priorities(per.leaf, np.full(32, 1.0),
                                     per.slot_gen - 1) == (0, 32)
    counts = np.bincount(per.leaf // tfac.leaf_stride, minlength=2)
    for s in (0, 1):
        if counts[s]:
            assert tfac.samplers[s].tree.total != before[s]
    _assert_states_equal(jfac.state_dict(), tfac.state_dict())


def test_sharded_state_dict_roundtrip_under_wraparound():
    """Twin of test_sharded_replay.py:216: after both rings wrapped, the
    snapshot (PER state included) equals JAX's and round-trips exactly:
    later draws from the clone are the original's."""
    kw = dict(n_step=2, alpha=0.6, beta=0.4, eps=1e-6)
    jfac, tfac = _facades(2, 48, 4, 60, chunks=5, **kw)
    _, per = tfac.sample(np.random.default_rng(1), 32, 0.99)
    prios = np.random.default_rng(0).random(32) * 3
    for fac in (jfac, tfac):
        fac.update_priorities(per.leaf, prios, per.slot_gen)
    snap = tfac.state_dict()
    _assert_states_equal(jfac.state_dict(), snap)
    clone = tsharded.ShardedHostReplay(2, 48, 4, (5,), np.float32)
    clone.attach_priority_samplers(native=False, **kw)
    clone.load_state_dict(snap)
    for s in (0, 1):
        assert (clone.rings[s].pos, clone.rings[s].size,
                clone.rings[s].generation) == (
            tfac.rings[s].pos, tfac.rings[s].size, tfac.rings[s].generation)
        assert clone.samplers[s].tree.total == tfac.samplers[s].tree.total
    _assert_draws_equal(tfac.sample(np.random.default_rng(7), 24, 0.99),
                        clone.sample(np.random.default_rng(7), 24, 0.99))


def test_sharded_state_dict_refusals():
    """Twin of test_sharded_replay.py:249: another shard count, a PER
    snapshot into a uniform facade and the reverse refuse, in JAX's
    words."""
    kw = dict(n_step=1, alpha=0.6, beta=0.4, eps=1e-6)
    _, per_fac = _facades(2, 32, 4, 70, **kw)
    snap = per_fac.state_dict()
    _, uni = _facades(2, 32, 4, 80)
    cases = [(3, False, snap), (2, False, snap), (2, True, uni.state_dict())]
    for shards, attach, state in cases:
        errors = []
        for mod in (jsharded, tsharded):
            fac = mod.ShardedHostReplay(shards, 32, 4, (5,), np.float32)
            if attach:
                fac.attach_priority_samplers(native=False, **kw)
            with pytest.raises(ValueError) as e:
                fac.load_state_dict(state)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_sharded_snapshot_consistent_while_other_shard_appends():
    """Twin of test_sharded_replay.py:273: a snapshot taken while another
    thread appends to shard 1 is all-or-nothing per shard: every stored
    slot's lanes agree with the generation that wrote them, and the newest
    generation holds a whole chunk."""
    fac = tsharded.ShardedHostReplay(2, 64, 4, (1,), np.float32)
    zeros = (np.zeros((8, 4), np.int32), np.zeros((8, 4), np.float32),
             np.zeros((8, 4), bool), np.zeros((8, 4), bool))
    fac.add_chunk(0, np.zeros((8, 4, 1), np.float32), *zeros)
    stop = threading.Event()

    def appender():
        j = 0
        while not stop.is_set():
            fac.add_chunk(1, np.full((8, 4, 1), float(j), np.float32),
                          *zeros)
            j += 1

    t = threading.Thread(target=appender, name="chunk-appender",
                         daemon=True)
    t.start()
    try:
        for _ in range(200):
            snap = fac.state_dict()
            size, pos = int(snap["shard1_size"]), int(snap["shard1_pos"])
            if size == 0:
                continue
            stored = (pos - size + np.arange(size)) % 64
            vals = snap["shard1_obs"][stored, :, 0]
            assert (vals == vals[:, :1]).all(), "torn lane row"
            np.testing.assert_array_equal(vals[:, 0] + 1,
                                          snap["shard1_slot_gen"][stored])
            newest = snap["shard1_slot_gen"][stored] == \
                int(snap["shard1_generation"])
            assert newest.sum() in (0, 8)
    finally:
        stop.set()
        t.join(5)


# --------------------------------------------------------------------------
# ShardedPrioritizedReplay (JAX :377-667) and the migration (:862-1010).
# --------------------------------------------------------------------------

def _stores(shards, capacity, **kw):
    return (jsharded.ShardedPrioritizedReplay(shards, capacity, native=False,
                                              **kw),
            tsharded.ShardedPrioritizedReplay(shards, capacity, native=False,
                                              **kw))


def test_apex_store_places_by_sticky_router_shard():
    """Twin of test_sharded_replay.py:162: every actor's inserts land in
    the shard its crc32 sticky assignment names."""
    _, store = _stores(2, 2048)
    per_actor = 40
    for actor in range(8):
        store.add({"obs": np.full((per_actor, 4), actor, np.float32),
                   "action": np.zeros(per_actor, np.int32)},
                  priorities=np.ones(per_actor),
                  shard=shard_for(actor, 2))
    assert store.added == 8 * per_actor
    for s in (0, 1):
        expected = sum(per_actor for a in range(8) if shard_for(a, 2) == s)
        assert len(store.shards[s]) == expected
        assert store.added_by_shard[s] == expected
        actors = np.unique(store.shards[s]._data["obs"][
            :len(store.shards[s]), 0])
        assert all(shard_for(int(a), 2) == s for a in actors)


def test_apex_store_sample_update_and_snapshot_roundtrip():
    """Twin of test_sharded_replay.py:186, against JAX's store: the same
    draws (slot ids, weights, items), write-backs and snapshot; a clone
    restores it, and a 4-shard store migrates it."""
    stores = _stores(2, 1024)
    draws = []
    for store in stores:
        rng = np.random.default_rng(0)
        for s in (0, 1):
            store.add({"obs": rng.random((100, 4)).astype(np.float32),
                       "action": np.zeros(100, np.int32)},
                      priorities=rng.random(100) + 0.1, shard=s)
        items, idx, w = store.sample(64, beta=0.4)
        store.update_priorities(idx, rng.random(64),
                                expected_gen=store.generation(idx))
        draws.append((items, idx, w))
    (ji, jidx, jw), (ti, tidx, tw) = draws
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tw, jw)
    assert ti["obs"].shape == (64, 4) and tw.max() == 1.0
    np.testing.assert_array_equal(ti["obs"], ji["obs"])
    snap = stores[1].state_dict()
    _assert_states_equal(stores[0].state_dict(), snap)
    clone = tsharded.ShardedPrioritizedReplay(2, 1024, native=False)
    clone.load_state_dict(snap)
    assert len(clone) == len(stores[1])
    migrated = tsharded.ShardedPrioritizedReplay(4, 1024, native=False)
    migrated.load_state_dict(snap)
    assert len(migrated) == len(stores[1])


def test_apex_store_unattributed_insert_refused():
    """Twin of test_sharded_replay.py:210, in JAX's words."""
    errors = []
    for store in _stores(2, 256):
        with pytest.raises(ValueError, match="shard id") as e:
            store.add({"obs": np.zeros((4, 2), np.float32)})
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_apex_store_reshards_2_to_4_and_2_to_1():
    """Twin of test_sharded_replay.py:332, against JAX's migrated stores:
    every record lands exactly once with its mass, into 4 shards, into 1
    and back up from 1 to 2; each target's snapshot equals JAX's."""
    results = []
    for mod, hmod in ((jsharded, jhost), (tsharded, thost)):
        rng = np.random.default_rng(0)
        store = mod.ShardedPrioritizedReplay(2, 1024, native=False)
        ids = np.arange(300, dtype=np.float32)
        pr = rng.random(300) + 0.1
        store.add({"id": ids[:140], "action": np.zeros(140, np.int32)},
                  priorities=pr[:140], shard=0)
        store.add({"id": ids[140:], "action": np.ones(160, np.int32)},
                  priorities=pr[140:], shard=1)
        snap = store.state_dict()
        src_mass = sum(s.tree.total for s in store.shards)
        t4 = mod.ShardedPrioritizedReplay(4, 1024, native=False)
        info4 = mod.restore_replay_snapshot(t4, snap)
        t1 = hmod.PrioritizedHostReplay(1024, native=False)
        info1 = mod.restore_replay_snapshot(t1, snap)
        t2 = mod.ShardedPrioritizedReplay(2, 1024, native=False)
        info2 = mod.restore_replay_snapshot(t2, t1.state_dict())
        results.append((t4, t1, t2, (info4, info1, info2), src_mass))
    (j4, j1, j2, jinfo, _), (t4, t1, t2, tinfo, src_mass) = results
    assert tinfo == jinfo
    assert tinfo[0] == {"records": 300, "from_shards": 2, "to_shards": 4,
                        "resharded": True}
    ids = np.arange(300, dtype=np.float32)
    got = np.concatenate([s._data["id"][:len(s)] for s in t4.shards])
    np.testing.assert_array_equal(np.sort(got), ids)
    np.testing.assert_allclose(sum(s.tree.total for s in t4.shards),
                               src_mass, rtol=1e-12)
    np.testing.assert_array_equal(np.sort(t1._data["id"][:len(t1)]), ids)
    for want, ours in ((j4, t4), (j1, t1), (j2, t2)):
        _assert_states_equal(want.state_dict(), ours.state_dict())
    items, idx, w = t4.sample(64, beta=0.4)
    assert items["id"].shape == (64,) and w.max() == 1.0
    t4.update_priorities(idx, np.random.default_rng(1).random(64),
                         expected_gen=t4.generation(idx))


def test_apex_reshard_refuses_alpha_mismatch():
    """Twin of test_sharded_replay.py:379, in JAX's words."""
    errors = []
    for mod in (jsharded, tsharded):
        store = mod.ShardedPrioritizedReplay(2, 512, alpha=0.6, native=False)
        for s in (0, 1):
            store.add({"id": np.zeros(20, np.float32)},
                      priorities=np.ones(20), shard=s)
        with pytest.raises(ValueError, match="priority_exponent") as e:
            mod.restore_replay_snapshot(
                mod.ShardedPrioritizedReplay(4, 512, alpha=0.5,
                                             native=False),
                store.state_dict())
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_apex_store_exact_restore_still_exact():
    """Twin of test_sharded_replay.py:395: a same-layout restore is the
    exact path (cursors, slot generations, counters)."""
    rng = np.random.default_rng(1)
    _, store = _stores(2, 512)
    for s in (0, 1):
        store.add({"obs": rng.random((100, 4)).astype(np.float32)},
                  priorities=rng.random(100) + 0.1, shard=s)
    clone = tsharded.ShardedPrioritizedReplay(2, 512, native=False)
    info = tsharded.restore_replay_snapshot(clone, store.state_dict())
    assert not info["resharded"]
    for s in (0, 1):
        assert clone.shards[s]._pos == store.shards[s]._pos
        assert clone.shards[s].added == store.shards[s].added
        np.testing.assert_array_equal(clone.shards[s]._slot_gen,
                                      store.shards[s]._slot_gen)


# --------------------------------------------------------------------------
# sampler="device" on the CPU planes (test_device_sharded_sampling.py).
# --------------------------------------------------------------------------

def _filled_facade(sampler, shards=2, per_shard=128, seed=11):
    """Every shard full, with one fixed spiky priority vector."""
    store = tsharded.ShardedPrioritizedReplay(
        shards, shards * per_shard, alpha=1.0, seed=seed, sampler=sampler,
        native=False, sampler_device="cpu")
    rng = np.random.default_rng(seed)
    pr = rng.uniform(0.5, 4.0, size=shards * per_shard)
    pr[::37] *= 10.0
    for s in range(shards):
        lo = s * per_shard
        store.add({"x": np.arange(lo, lo + per_shard, dtype=np.float32)},
                  priorities=pr[lo:lo + per_shard], shard=s)
    return store, pr + 1e-6


def test_facade_device_matches_tree_distribution():
    """Twin of test_device_sharded_sampling.py:63: the device planes under
    the global ladder and the host trees both draw P(i) ~ p ** alpha, and
    the device weights follow the global ``(N * P) ** -beta``."""
    dev, pr = _filled_facade("device")
    tre, _ = _filled_facade("tree")
    n = pr.shape[0]
    counts = {"device": np.zeros(n), "tree": np.zeros(n)}
    for _ in range(40):
        items, idx, w = dev.sample(256, beta=1.0)
        np.testing.assert_allclose(items["x"], idx.astype(np.float32))
        counts["device"] += np.bincount(idx, minlength=n)
        _, idx_t, _ = tre.sample(256, beta=1.0)
        counts["tree"] += np.bincount(idx_t, minlength=n)
    for c in counts.values():
        np.testing.assert_allclose(c / c.sum(), pr / pr.sum(), atol=0.01)
    ref = (n * pr[idx] / pr.sum()) ** -1.0
    np.testing.assert_allclose(w, (ref / ref.max()).astype(np.float32),
                               rtol=1e-4)


def test_facade_device_dispatch_budget_and_no_host_tree():
    """Twin of test_device_sharded_sampling.py:94: one plane draw per
    shard per sample, and no host tree behind the planes."""
    store, _ = _filled_facade("device")
    assert all(s.tree is None and s.device_sampler is not None
               for s in store.shards)
    assert store.device_sample_dispatches == 0
    for _ in range(5):
        store.sample(64, beta=0.4)
    assert store.device_sample_dispatches == 5 * store.num_shards


def test_facade_writeback_generation_guard_parity():
    """Twin of test_device_sharded_sampling.py:111: stale write-backs drop
    alike on the planes and the trees, and the live rows take the new
    mass."""
    dev, _ = _filled_facade("device", per_shard=64)
    tre, _ = _filled_facade("tree", per_shard=64)
    idx = np.concatenate([np.arange(8) + s * 64 for s in range(2)])
    gen_d, gen_t = dev.generation(idx), tre.generation(idx)
    np.testing.assert_array_equal(gen_d, gen_t)
    for st in (dev, tre):
        for s in range(2):
            st.add({"x": np.full(4, -1.0, np.float32)},
                   priorities=np.full(4, 2.0), shard=s)
    dev.update_priorities(idx, np.full(16, 99.0), expected_gen=gen_d)
    tre.update_priorities(idx, np.full(16, 99.0), expected_gen=gen_t)
    for s in range(2):
        d = dev.shards[s].device_sampler
        d._flush_writes()
        plane = d.plane.reshape(-1)[:64].double().numpy()
        tree = tre.shards[s].tree.get(np.arange(64, dtype=np.int64))
        np.testing.assert_allclose(plane, tree, rtol=1e-6)
        np.testing.assert_allclose(plane[:4], 2.0 + 1e-6, rtol=1e-6)
        np.testing.assert_allclose(plane[4:8], 99.0 + 1e-6, rtol=1e-6)


def test_ring_facade_device_planes_draw_the_tree_facade_ladder():
    """``ShardedHostReplay`` with device planes (one per shard, on the
    CPU) under the global ladder: the same slots as the host-tree facade
    at the same generator, where no draw falls on a rounding boundary."""
    kw = dict(n_step=2, alpha=0.6, beta=0.4, eps=1e-6)
    tree = tsharded.ShardedHostReplay(2, 64, 4, (5,), np.float32)
    tree.attach_priority_samplers(native=False, **kw)
    plane = tsharded.ShardedHostReplay(2, 64, 4, (5,), np.float32)
    planes = plane.attach_priority_samplers(device_sampling=True,
                                            devices=["cpu"], **kw)
    assert [p.plane.device.type for p in planes] == ["cpu", "cpu"]
    for fac in (tree, plane):
        for s in (0, 1):
            _fill(fac, s, np.random.default_rng(90 + s), chunks=2, C=20)
    _, a = tree.sample(np.random.default_rng(8), 32, 0.99)
    _, b = plane.sample(np.random.default_rng(8), 32, 0.99)
    assert (a.leaf == b.leaf).mean() > 0.9
    np.testing.assert_allclose(a.weights, b.weights, rtol=1e-4)
