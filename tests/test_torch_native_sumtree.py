"""The port's C++ sum-tree (dist_dqn_tpu_torch/replay/_native/sumtree.cc
through replay/host.py ``NativeSumTree``) against the JAX package's numpy
``SumTree``, mirroring tests/test_prioritized.py:106-128, and the backend
choice of ``make_sum_tree``.

JAX's own C++ tree is no anchor: its source does not compile with g++ 12
(``size_t`` without ``<cstddef>``), so its tests are red. The numpy tree is
exact at every write; the native tree propagates deltas, so totals agree to
rtol 1e-12 while leaf reads and draws agree exactly."""
import warnings

import numpy as np
import pytest

from dist_dqn_tpu.replay import host as jhost
from dist_dqn_tpu_torch.actors import transport as ttransport
from dist_dqn_tpu_torch.replay import host as thost
from dist_dqn_tpu_torch.replay import host_ring as tring


def _last_wins(rng, cap, n):
    idx = rng.integers(0, cap, size=n)
    vals = rng.uniform(0.0, 5.0, size=n)
    _, last = np.unique(idx[::-1], return_index=True)
    keep = n - 1 - last
    return idx[keep], vals[keep]


def test_native_sumtree_matches_jax_numpy_tree():
    """Totals (rtol 1e-12), leaf reads (exact) and descents (exact) across
    batched writes, overwrites and draws."""
    cap = 37                                # both pad to 64
    nat, ref = thost.NativeSumTree(cap), jhost.SumTree(cap)
    assert nat.capacity == ref.capacity == 64
    rng = np.random.default_rng(7)
    for _ in range(20):
        idx, vals = _last_wins(rng, cap, int(rng.integers(1, 48)))
        nat.set(idx, vals)
        ref.set(idx, vals)
        np.testing.assert_allclose(nat.total, ref.total, rtol=1e-12)
        probe = rng.integers(0, cap, size=16)
        np.testing.assert_array_equal(nat.get(probe), ref.get(probe))
        mass = rng.uniform(0.0, ref.total, size=256)
        np.testing.assert_array_equal(nat.sample(mass), ref.sample(mass))


def test_native_sumtree_rebuild_is_exact():
    nat = thost.NativeSumTree(16)
    rng = np.random.default_rng(11)
    for _ in range(50):
        nat.set(rng.integers(0, 16, size=8), rng.uniform(size=8))
    leaves = nat.get(np.arange(16))
    nat._lib.dqn_tree_rebuild(nat._h)
    np.testing.assert_allclose(nat.total, leaves.sum(), rtol=1e-12)
    assert nat._lib.dqn_tree_writes(nat._h) == 0
    ref = jhost.SumTree(16)
    ref.set(np.arange(16), leaves)
    np.testing.assert_array_equal(nat.state_dict()["nodes"], ref.tree)


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("bad", [[16], [-1], [3, 99]])
def test_sumtrees_reject_out_of_range_indices(backend, bad):
    tree = (thost.NativeSumTree(16) if backend == "native"
            else thost.SumTree(16))
    bad = np.array(bad)
    with pytest.raises(IndexError, match="out of range"):
        tree.set(bad, np.ones(bad.shape[0]))
    with pytest.raises(IndexError, match="out of range"):
        tree.get(bad)


def test_state_dict_round_trips_bit_for_bit():
    """The heap, with its delta-propagation drift, and the write counter
    come back exactly; the restored tree then draws and writes like the
    original."""
    rng = np.random.default_rng(3)
    src = thost.NativeSumTree(1000)
    for _ in range(30):
        src.set(*_last_wins(rng, 1000, 200))
    state = src.state_dict()
    assert bytes(state["backend"]) == b"native"
    assert int(state["writes"]) == src._lib.dqn_tree_writes(src._h) > 0
    dst = thost.NativeSumTree(1000)
    dst.load_state_dict(state)
    again = dst.state_dict()
    assert again["nodes"].tobytes() == state["nodes"].tobytes()
    assert int(again["writes"]) == int(state["writes"])
    mass = rng.uniform(0.0, src.total, 512)
    np.testing.assert_array_equal(dst.sample(mass), src.sample(mass))
    idx, vals = _last_wins(rng, 1000, 100)
    for t in (src, dst):
        t.set(idx, vals)
    assert dst.state_dict()["nodes"].tobytes() == \
        src.state_dict()["nodes"].tobytes()
    with pytest.raises(ValueError, match="padded slots"):
        thost.NativeSumTree(10).load_state_dict(state)


def test_make_sum_tree_picks_the_native_tree():
    assert isinstance(thost.make_sum_tree(8), thost.NativeSumTree)
    assert isinstance(thost.make_sum_tree(8, native=True),
                      thost.NativeSumTree)
    assert isinstance(thost.make_sum_tree(8, native=False), thost.SumTree)
    assert isinstance(thost.PrioritizedHostReplay(8).tree,
                      thost.NativeSumTree)


@pytest.fixture
def broken_build(monkeypatch):
    """The native build fails (as JAX's does here): a fresh library slot,
    a build that raises, and the one-time warning not yet given."""
    def fail(*a, **k):
        raise RuntimeError("g++ failed (1): simulated")

    monkeypatch.setattr(thost, "_tree_lib", None)
    monkeypatch.setattr(thost, "_fallback_warned", False)
    monkeypatch.setattr(ttransport, "build_native_lib", fail)


def test_a_failed_build_falls_back_with_one_warning(broken_build):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = thost.make_sum_tree(8)
        second = thost.make_sum_tree(8)
    assert isinstance(first, thost.SumTree)
    assert isinstance(second, thost.SumTree)
    runtime = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(runtime) == 1
    assert "native sum-tree unavailable" in str(runtime[0].message)
    assert "using numpy tree" in str(runtime[0].message)


def test_a_failed_build_raises_when_native_is_asked_for(broken_build):
    with pytest.raises(RuntimeError, match="simulated"):
        thost.make_sum_tree(8, native=True)
    assert isinstance(thost.make_sum_tree(8, native=False), thost.SumTree)


def _ring_sampler(native):
    ring = tring.HostTimeRing(64, 4, (2,), np.uint8)
    sampler = tring.RingPrioritySampler(ring, n_step=3, native=native)
    rng = np.random.default_rng(2)
    for _ in range(20):
        ring.add_chunk(rng.integers(0, 255, (1, 4, 2), dtype=np.uint8),
                       rng.integers(0, 2, (1, 4)).astype(np.int32),
                       rng.normal(size=(1, 4)).astype(np.float32),
                       np.zeros((1, 4), bool), np.zeros((1, 4), bool))
    idx = np.arange(0, 40, 3)
    sampler.update_priorities(idx, rng.uniform(0.1, 3.0, idx.shape[0]),
                              ring.slot_gen[idx // ring.num_envs])
    return sampler


@pytest.mark.parametrize("saved,live", [(True, True), (True, False),
                                        (False, True)])
def test_ring_sampler_restores_across_backends(saved, live):
    """A host-ring PER snapshot restores into either backend: the heap as
    it is when the backend matches, a rebuild from the mass otherwise; the
    restored sampler's total equals the source's."""
    src = _ring_sampler(saved)
    state = src.state_dict()
    dst = _ring_sampler(live)
    dst.load_state_dict(state)
    assert type(dst.tree).__name__ == ("NativeSumTree" if live
                                       else "SumTree")
    np.testing.assert_allclose(dst.tree.total, src.tree.total, rtol=1e-12)
    if saved == live:
        assert dst.tree.state_dict()["nodes"].tobytes() == \
            src.tree.state_dict()["nodes"].tobytes()
