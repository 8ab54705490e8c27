"""Port parity of R2D2's sequence replay (replay/sequence_device.py)
against the JAX package, exactly: both rings take the same adds (seeding
and clearing across a wrap, tiled and merged obs rows) and the same
write-backs; both draw at the same stratified uniforms through both routes
(the kernel wrapper, which runs the plain version on the CPU, against the
Pallas kernel in interpret mode; the cumsum twin against the XLA path).
Indices, windows, flags, start states and the priority plane are equal;
IS weights agree to f32 rtol 1e-6 (a power and a division)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.replay import sequence_device as jsring
from dist_dqn_tpu_torch.ops import sampler as tps
from dist_dqn_tpu_torch.replay import sequence_device as tsring

SLOTS, B, LSTM, OBS = 12, 3, 4, (3, 2)


def _add_both(jr, tr, rng, seq_len, stride, merge):
    obs = rng.normal(size=(B,) + OBS).astype(np.float32)
    action = rng.integers(0, 3, B).astype(np.int32)
    reward = rng.normal(size=B).astype(np.float32)
    term = rng.uniform(size=B) < 0.15
    trunc = rng.uniform(size=B) < 0.05
    carry = tuple(rng.normal(size=(B, LSTM)).astype(np.float32)
                  for _ in range(2))
    flat = (lambda x: x.reshape(B, -1)) if merge else (lambda x: x)
    jr = jsring.sequence_ring_add(
        jr, jnp.asarray(flat(obs)), jnp.asarray(action), jnp.asarray(reward),
        jnp.asarray(term), jnp.asarray(trunc),
        tuple(jnp.asarray(c) for c in carry), seq_len, stride,
        merge_obs_rows=merge)
    tsring.sequence_ring_add(
        tr, torch.from_numpy(flat(obs)), torch.from_numpy(action).long(),
        torch.from_numpy(reward), torch.from_numpy(term),
        torch.from_numpy(trunc), tuple(torch.from_numpy(c) for c in carry),
        seq_len, stride, merge_obs_rows=merge)
    return jr


def _update_both(jr, tr, rng, n=5):
    t = rng.integers(0, SLOTS, n).astype(np.int32)
    b = rng.integers(0, B, n).astype(np.int32)
    p = rng.uniform(0.1, 5.0, n).astype(np.float32)
    # One (t, b) pair per cell, so the scatter order cannot matter.
    _, first = np.unique(t * B + b, return_index=True)
    t, b, p = t[first], b[first], p[first]
    jr = jsring.sequence_ring_update(jr, jnp.asarray(t), jnp.asarray(b),
                                     jnp.asarray(p))
    tsring.sequence_ring_update(tr, torch.from_numpy(t), torch.from_numpy(b),
                                torch.from_numpy(p))
    return jr


def _assert_rings_equal(jr, tr):
    np.testing.assert_array_equal(tr.priorities.numpy(),
                                  np.asarray(jr.priorities))
    assert float(tr.max_priority) == float(jr.max_priority)
    assert tr.writes == int(jr.writes)
    assert tr.ring.pos == int(jr.ring.pos)
    assert tr.ring.size == int(jr.ring.size)
    for name in ("state_c", "state_h"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)))
    for name in ("obs", "action", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(tr.ring, name).numpy(),
                                      np.asarray(getattr(jr.ring, name)),
                                      err_msg=name)


def _filled(seq_len, stride, merge, writes=30, seed=0):
    rng = np.random.default_rng(seed)
    example = np.zeros((int(np.prod(OBS)),) if merge else OBS, np.float32)
    jr = jsring.sequence_ring_init(SLOTS, B, jnp.asarray(example), LSTM,
                                   merge_obs_rows=merge)
    tr = tsring.sequence_ring_init(SLOTS, B, torch.from_numpy(example),
                                   LSTM, merge_obs_rows=merge)
    for w in range(writes):
        jr = _add_both(jr, tr, rng, seq_len, stride, merge)
        np.testing.assert_array_equal(tr.priorities.numpy(),
                                      np.asarray(jr.priorities))
        if w % 7 == 6:
            jr = _update_both(jr, tr, rng)
    return jr, tr


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("seq_len,stride", [(4, 2), (5, 3), (4, 1)])
def test_add_seed_clear_across_wrap_matches_jax(merge, seq_len, stride):
    jr, tr = _filled(seq_len, stride, merge)
    _assert_rings_equal(jr, tr)


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_sample_at_same_uniforms_matches_jax(use_kernel, merge):
    seq_len, S, alpha, beta = 5, 8, 0.9, 0.6
    jr, tr = _filled(seq_len, 2, merge)
    key = jax.random.PRNGKey(4)
    u01 = np.array((jnp.arange(S, dtype=jnp.float32)
                    + jax.random.uniform(key, (S,))) / S)
    js = jsring.sequence_ring_sample(
        jr, key, S, seq_len, alpha, jnp.float32(beta), use_pallas=use_kernel,
        pallas_interpret=use_kernel, merge_obs_rows=merge)
    launches = tps.kernel_stratified_sample.launches
    ts = tsring.sequence_ring_sample(tr, None, S, seq_len, alpha, beta,
                                     use_kernel=use_kernel,
                                     merge_obs_rows=merge,
                                     u=torch.from_numpy(u01))
    assert tps.kernel_stratified_sample.launches == launches  # CPU: plain
    for name in ("t_idx", "b_idx", "obs", "action", "reward", "done",
                 "reset"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    for got, want in zip(ts.start_state, js.start_state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(ts.weights.numpy(), np.asarray(js.weights),
                               rtol=1e-6)
    assert ts.obs.shape[:2] == (seq_len, S)
    assert not ts.reset[0].any()
    # Every drawn start is live.
    assert (tr.priorities[ts.t_idx.long(), ts.b_idx.long()] > 0).all()


def test_update_ignores_overwritten_starts():
    """As ``tests/test_r2d2.py``: slot 2 is a live start, slot 7's window
    is incomplete; both packages keep 7 at zero."""
    example = np.zeros(2, np.float32)
    jr = jsring.sequence_ring_init(8, 1, jnp.asarray(example), lstm_size=4)
    tr = tsring.sequence_ring_init(8, 1, torch.from_numpy(example), 4)
    for t in range(8):
        carry = (np.full((1, 4), t, np.float32),
                 np.full((1, 4), -t, np.float32))
        jr = jsring.sequence_ring_add(
            jr, jnp.full((1, 2), float(t)), jnp.full((1,), t % 3, jnp.int32),
            jnp.full((1,), float(t)), jnp.zeros((1,), bool),
            jnp.zeros((1,), bool), tuple(jnp.asarray(c) for c in carry),
            3, 1)
        tsring.sequence_ring_add(
            tr, torch.full((1, 2), float(t)), torch.full((1,), t % 3),
            torch.full((1,), float(t)), torch.zeros(1, dtype=torch.bool),
            torch.zeros(1, dtype=torch.bool),
            tuple(torch.from_numpy(c) for c in carry), 3, 1)
    jr = jsring.sequence_ring_update(jr, jnp.array([2, 7], jnp.int32),
                                     jnp.array([0, 0], jnp.int32),
                                     jnp.array([5.0, 5.0]))
    tsring.sequence_ring_update(tr, torch.tensor([2, 7]), torch.tensor([0, 0]),
                                torch.tensor([5.0, 5.0]))
    p = tr.priorities[:, 0].numpy()
    assert p[2] > 4.9 and p[7] == 0.0 and float(tr.max_priority) >= 5.0
    _assert_rings_equal(jr, tr)


@pytest.mark.parametrize("num_slots,seq_len,stride", [
    (12, 4, 2), (12, 5, 3), (10, 4, 1), (9, 4, 5), (6250, 125, 40)])
def test_host_live_starts_equal_the_priority_plane(num_slots, seq_len,
                                                   stride):
    """The loop's host predicate: after every add (and write-backs at the
    drawn cells), the rows with priority > 0 are exactly the slots of
    ``live_start_writes``, every lane of them; ``can_train``'s
    ``any(priorities > 0)`` is the predicate's non-emptiness."""
    torch.manual_seed(0)
    lanes = 2
    tr = tsring.sequence_ring_init(num_slots, lanes, torch.zeros(1), 1)
    zeros = torch.zeros(lanes)
    no = torch.zeros(lanes, dtype=torch.bool)
    writes = 2 * num_slots + 3 if num_slots < 100 else num_slots + 400
    for w in range(writes):
        tsring.sequence_ring_add(tr, zeros[:, None], zeros.long(), zeros, no,
                                 no, (zeros[:, None], zeros[:, None]),
                                 seq_len, stride)
        live = tsring.live_start_writes(tr.writes, num_slots, seq_len,
                                        stride)
        rows = (tr.priorities > 0).any(dim=1)
        assert sorted(s % num_slots for s in live) == \
            rows.nonzero()[:, 0].tolist(), w
        assert bool((tr.priorities[rows] > 0).all())
        assert (len(live) > 0) == bool(rows.any())
        if live:
            t = torch.tensor([live[0] % num_slots, live[-1] % num_slots])
            tsring.sequence_ring_update(tr, t, torch.tensor([0, 1]),
                                        torch.rand(2) * 3)
