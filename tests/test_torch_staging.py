"""The host-replay runtime's staging pipeline on the CPU
(dist_dqn_tpu_torch/replay/staging.py): the port's twins of the JAX
package's unit cases in tests/test_host_replay_pipeline.py for the
streamed evacuator, the evacuation worker, the sample prefetcher and the
double-buffered stager (slice order and clamping, completion handles,
failure propagation without a hang, the generation-fence handshake and
the stale-batch redraw). No case depends on which thread runs first.
The pinned-buffer and stream fences run on the card only; there the
uniform pipelined/serial pair of chip_smoke.py holds them.
"""
import threading

import numpy as np
import pytest
import torch

from dist_dqn_tpu_torch import host_replay_loop as hrl
from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
from dist_dqn_tpu_torch.replay.host_ring import HostTimeRing
from dist_dqn_tpu_torch.replay.staging import (DoubleBufferedStager,
                                               EvacuationWorker,
                                               SamplePrefetcher,
                                               StreamedEvacuator,
                                               tree_flatten)


def _records(C=12, B=3):
    return {"obs": torch.arange(C * B * 2, dtype=torch.float32
                                ).reshape(C, B, 2),
            "action": torch.arange(C * B, dtype=torch.int64).reshape(C, B)}


def test_evacuator_slices_cover_the_chunk_in_order():
    ev = StreamedEvacuator(num_slices=5)
    records = _records()
    got, spans = [], []
    stats = ev.drain(ev.start(records), lambda tree, lo, hi: (
        got.append({k: v.copy() for k, v in tree.items()}),
        spans.append((lo, hi))))
    assert spans == [(0, 3), (3, 6), (6, 8), (8, 10), (10, 12)]
    for k, v in records.items():
        np.testing.assert_array_equal(
            np.concatenate([s[k] for s in got]), v.numpy())
    assert stats["slices"] == 5
    assert stats["bytes"] == sum(v.numpy().nbytes for v in records.values())
    assert ev.slices_total == 5


@pytest.mark.parametrize("slices,want", [
    (64, [(0, 1), (1, 2), (2, 3), (3, 4)]), (1, [(0, 4)])])
def test_evacuator_clamps_slices_to_the_chunk(slices, want):
    ev = StreamedEvacuator(num_slices=slices)
    spans = []
    ev.drain(ev.start(_records(C=4)),
             lambda tree, lo, hi: spans.append((lo, hi)))
    assert spans == want
    with pytest.raises(ValueError, match="num_slices"):
        StreamedEvacuator(num_slices=0)


def _worker(on_slice, num_slices=3):
    return EvacuationWorker(StreamedEvacuator(num_slices=num_slices),
                            on_slice)


def test_worker_handle_completes_and_shuts_down():
    done = []
    w = _worker(lambda tree, lo, hi: done.append((lo, hi)))
    try:
        h = w.submit({"x": torch.ones(9, 2, 4)})
        assert h.wait(timeout=30)
        assert h.done and h.stats["slices"] == 3
        assert done == [(0, 3), (3, 6), (6, 9)]
    finally:
        w.close()
    assert not w._thread.is_alive()


def test_worker_failure_propagates_to_every_queued_job():
    """A failing append re-raises at the fence, fails every job queued
    behind it and poisons later submits; the thread still closes."""
    gate = threading.Event()

    def boom(tree, lo, hi):
        gate.wait(timeout=30)
        raise RuntimeError("ring append exploded")

    w = _worker(boom, num_slices=1)
    try:
        h1 = w.submit({"x": torch.ones(4, 2)})
        h2 = w.submit({"x": torch.ones(4, 2)})
        gate.set()
        for h in (h1, h2):
            with pytest.raises(RuntimeError, match="exploded"):
                h.wait(timeout=30)
        assert w.failed is not None
        with pytest.raises(RuntimeError, match="worker died"):
            w.submit({"x": torch.ones(4, 2)})
    finally:
        w.close()
    assert not w._thread.is_alive()


def _ring_and_sampler(slots=128, lanes=2):
    ring = HostTimeRing(slots, lanes, (3,), np.float32)

    def append(v, C=16):
        ring.add_chunk(np.full((C, lanes, 3), v, np.float32),
                       np.full((C, lanes), int(v), np.int32),
                       np.full((C, lanes), v, np.float32),
                       np.zeros((C, lanes), bool),
                       np.zeros((C, lanes), bool))

    def sample_fn(k):
        rng = np.random.default_rng(np.random.SeedSequence(0,
                                                           spawn_key=(k,)))
        hs = ring.sample(rng, 32, n_step=1, gamma=0.99)
        return {"obs": hs.batch.obs, "action": hs.batch.action,
                "reward": hs.batch.reward}, hs

    return ring, append, sample_fn


def test_prefetcher_pops_in_order_and_matches_a_redraw():
    ring, append, sample_fn = _ring_and_sampler()
    append(1.0)
    p = SamplePrefetcher(sample_fn, depth=2,
                         wait_generation=ring.wait_generation)
    try:
        p.request(4, ring.generation)
        for k in range(4):
            dev, aux = p.pop(ring.generation)
            redraw, re_aux = sample_fn(k)
            np.testing.assert_array_equal(dev["action"].numpy(),
                                          redraw["action"])
            assert (dev["obs"].numpy() == 1.0).all()
            assert aux.generation == re_aux.generation
        assert p.stale_total == 0 and p.next_k == 4
        p.seek(10)
        assert p.next_k == 10
    finally:
        p.close()
    assert not p._thread.is_alive()


def test_prefetcher_waits_for_a_generation_not_yet_published():
    ring, append, sample_fn = _ring_and_sampler()
    append(1.0)
    p = SamplePrefetcher(sample_fn, depth=2,
                         wait_generation=ring.wait_generation)
    try:
        target = ring.generation + 1
        p.request(1, target)
        append(2.0)
        dev, aux = p.pop(target)
        assert aux.generation >= target
    finally:
        p.close()


def test_prefetcher_drops_and_redraws_a_stale_batch():
    """Batches drawn against an older window than the pop's fence are
    counted, dropped and drawn again at the fenced window, whole (every
    obs matches its action stamp)."""
    ring, append, sample_fn = _ring_and_sampler()
    append(1.0)
    p = SamplePrefetcher(sample_fn, depth=2,
                         wait_generation=ring.wait_generation)
    try:
        old_gen = ring.generation
        p.request(2, old_gen)
        for _ in range(3000):
            if p.sampled_total == 2:
                break
            threading.Event().wait(0.01)
        assert p.sampled_total == 2
        append(2.0)
        dev, aux = p.pop(ring.generation)
        assert p.stale_total == 1 and aux.generation == old_gen + 1
        obs, act = dev["obs"].numpy(), dev["action"].numpy()
        assert (obs == act[:, None].astype(np.float32)).all()
    finally:
        p.close()


def test_prefetcher_failure_reraises_from_pop_and_request():
    def boom(k):
        raise RuntimeError("gather exploded")

    p = SamplePrefetcher(boom, depth=2)
    try:
        p.request(1, 0)
        with pytest.raises(RuntimeError, match="exploded"):
            p.pop(0)
        with pytest.raises(RuntimeError, match="died"):
            p.request(1, 0)
    finally:
        p.close()
    assert not p._thread.is_alive()


def test_stager_is_a_bounded_fifo_of_copies():
    """Batches come back oldest first, as copies (a later stage into the
    same buffer set leaves a popped batch as it was), and the stager
    refuses a third batch at depth 2 or a batch of another structure."""
    stager = DoubleBufferedStager(depth=2)
    for v in (1.0, 2.0):
        stager.stage((np.full((4, 3), v, np.float32),
                      np.arange(4) + int(v)), aux=v)
    with pytest.raises(RuntimeError, match="depth 2 exceeded"):
        stager.stage((np.zeros((4, 3), np.float32), np.arange(4)))
    (obs, act), aux = stager.pop()
    stager.stage((np.full((4, 3), 3.0, np.float32), np.arange(4)), aux=3.0)
    assert aux == 1.0 and (obs.numpy() == 1.0).all()
    assert act.tolist() == [1, 2, 3, 4]
    assert [stager.pop()[1] for _ in range(2)] == [2.0, 3.0]
    with pytest.raises(ValueError, match="do not match"):
        stager.stage((np.zeros((5, 3), np.float32), np.arange(5)))
    with pytest.raises(RuntimeError, match="empty stager"):
        stager.pop()
    assert stager.bytes_staged == 3 * (48 + 32)


def test_tree_flatten_rebuilds_namedtuples_and_dicts():
    from dist_dqn_tpu_torch.types import Transition
    tree = (Transition(*(np.full(2, i) for i in range(5))),
            {"b": np.ones(1), "a": np.zeros(1)})
    leaves, rebuild = tree_flatten(tree)
    assert len(leaves) == 7
    back = rebuild([x * 2 for x in leaves])
    assert isinstance(back[0], Transition) and back[0].reward[0] == 4
    assert list(back[1]) == ["b", "a"]


def _tiny_cfg():
    return apply_overrides(CONFIGS["cartpole"], [
        "network.mlp_features=(32,)", "replay.capacity=4096",
        "replay.min_fill=64", "learner.batch_size=16", "actor.num_envs=8"])


@pytest.mark.parametrize("where", ["add_chunk", "sample"])
def test_loop_surfaces_a_background_failure(monkeypatch, where):
    """A ring append (on the evacuation worker) or a ring draw (on the
    prefetcher) that fails mid-run aborts run_host_replay with that
    exception, after closing its threads, instead of hanging a fence."""
    real = getattr(HostTimeRing, where)

    def failing(self, *a, **k):
        if self.generation >= 3:
            raise RuntimeError(f"{where} failed")
        return real(self, *a, **k)

    monkeypatch.setattr(HostTimeRing, where, failing)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        hrl.run_host_replay(_tiny_cfg(), total_env_steps=3200,
                            chunk_iters=50, log_fn=lambda s: None,
                            device="cpu")
    assert threading.active_count() == threads
