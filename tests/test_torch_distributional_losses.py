"""Port parity: the distributional and regularised losses
(dist_dqn_tpu_torch/ops/losses.py) against the JAX package's
(dist_dqn_tpu/ops/losses.py:84-278), values and gradients.

Same numpy-seeded inputs through both. Tolerance: f32 rtol 1e-5 / atol
1e-6 for values and gradients (exp, log and sums run in other orders in
XLA and torch); integer selections (argmax, midpoints) are exact.
Gradients are ``torch.autograd`` against ``jax.grad`` of the IS-weighted
sum, taken with respect to the prediction and, where the JAX loss
stop-grads it, the target too: there both packages give zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.ops import losses as jl
from dist_dqn_tpu_torch.ops import losses as tl

RTOL, ATOL = 1e-5, 1e-6
B, A, M = 16, 5, 11


def _close(got, want, **kw):
    kw = {"rtol": RTOL, "atol": ATOL, **kw}
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **kw)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _grads(torch_fn, jax_fn, args, wrt, weights):
    """(port grads, JAX grads) of sum(weights * fn(*args)) w.r.t. the
    arguments at ``wrt``; a torch input the loss detaches gets zeros."""
    targs = [_t(a, grad=i in wrt) for i, a in enumerate(args)]
    out = (torch.from_numpy(weights) * torch_fn(*targs)).sum()
    got = torch.autograd.grad(out, [targs[i] for i in wrt],
                              allow_unused=True)
    got = [np.zeros_like(args[i]) if g is None else g.numpy()
           for i, g in zip(wrt, got)]

    def scalar(*xs):
        return jnp.sum(jnp.asarray(weights) * jax_fn(*xs))

    want = jax.grad(scalar, argnums=tuple(wrt))(
        *[jnp.asarray(a) for a in args])
    return got, [np.asarray(w) for w in want]


def _rng(seed):
    return np.random.default_rng(seed)


def _weights(rng):
    return rng.uniform(0.2, 1.0, B).astype(np.float32)


@pytest.mark.parametrize("tau", [0.03, 1.0])
def test_munchausen_soft_bootstrap(tau):
    rng = _rng(0)
    q = (rng.normal(size=(B, A)) * 5).astype(np.float32)
    _close(tl.munchausen_soft_bootstrap(_t(q), tau).numpy(),
           jl.munchausen_soft_bootstrap(jnp.asarray(q), tau))
    got, want = _grads(lambda x: tl.munchausen_soft_bootstrap(x, tau),
                       lambda x: jl.munchausen_soft_bootstrap(x, tau),
                       [q], [0], _weights(rng))
    _close(got[0], want[0])


@pytest.mark.parametrize("tau,clip_low", [(0.03, -1.0), (1.0, -0.5)])
def test_munchausen_bonus(tau, clip_low):
    rng = _rng(1)
    q = (rng.normal(size=(B, A)) * 3).astype(np.float32)
    actions = rng.integers(0, A, B).astype(np.int32)
    got = tl.munchausen_bonus(_t(q), _t(actions), 0.9, tau, clip_low)
    want = jl.munchausen_bonus(jnp.asarray(q), jnp.asarray(actions), 0.9,
                               tau, clip_low)
    _close(got.numpy(), want)
    # Both the clip (very off-policy actions) and the open range occur.
    assert (np.asarray(want) == 0.9 * clip_low).any()
    assert (np.asarray(want) > 0.9 * clip_low).any()
    got, want = _grads(
        lambda x: tl.munchausen_bonus(x, _t(actions), 0.9, tau, clip_low),
        lambda x: jl.munchausen_bonus(x, jnp.asarray(actions), 0.9, tau,
                                      clip_low), [q], [0], _weights(rng))
    _close(got[0], want[0])


def _c51_inputs(seed, v_min=-10.0, v_max=10.0):
    rng = _rng(seed)
    atoms = np.asarray(jnp.linspace(v_min, v_max, M))
    probs = rng.dirichlet(np.ones(M), B).astype(np.float32)
    rewards = rng.normal(size=B).astype(np.float32) * 4
    discounts = (rng.uniform(size=B) < 0.8).astype(np.float32) * 0.97
    rewards[:2] = [50.0, -50.0]       # clipped at the support's ends
    return rng, atoms, probs, rewards, discounts


def test_categorical_projection_values_and_rows_sum_to_one():
    rng, atoms, probs, rewards, discounts = _c51_inputs(2)
    got = tl.categorical_projection(_t(atoms), _t(probs), _t(rewards),
                                    _t(discounts)).numpy()
    want = jl.categorical_projection(jnp.asarray(atoms), jnp.asarray(probs),
                                     jnp.asarray(rewards),
                                     jnp.asarray(discounts))
    _close(got, want)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-5)
    assert (got >= 0).all()
    # A clipped reward lands all its mass on the support's end.
    assert got[0, -1] == pytest.approx(1.0) and got[1, 0] == pytest.approx(1.0)
    got, want = _grads(
        lambda p: tl.categorical_projection(_t(atoms), p, _t(rewards),
                                            _t(discounts)).sum(1),
        lambda p: jl.categorical_projection(
            jnp.asarray(atoms), p, jnp.asarray(rewards),
            jnp.asarray(discounts)).sum(1), [probs], [0], _weights(rng))
    _close(got[0], want[0])


@pytest.mark.parametrize("double", [True, False])
def test_categorical_double_q_probs(double):
    rng, atoms, _, _, _ = _c51_inputs(3)
    online = rng.normal(size=(B, A, M)).astype(np.float32)
    target = rng.normal(size=(B, A, M)).astype(np.float32)
    selector = online if double else target
    got = tl.categorical_double_q_probs(_t(selector), _t(target), _t(atoms))
    want = jl.categorical_double_q_probs(jnp.asarray(selector),
                                         jnp.asarray(target),
                                         jnp.asarray(atoms))
    _close(got.numpy(), want)


def test_categorical_td_loss_values_and_gradients():
    rng, _, probs, _, _ = _c51_inputs(4)
    logits = (rng.normal(size=(B, A, M)) * 2).astype(np.float32)
    actions = rng.integers(0, A, B).astype(np.int32)
    _close(tl.categorical_td_loss(_t(logits), _t(actions), _t(probs)),
           jl.categorical_td_loss(jnp.asarray(logits), jnp.asarray(actions),
                                  jnp.asarray(probs)))
    got, want = _grads(
        lambda lg, p: tl.categorical_td_loss(lg, _t(actions), p),
        lambda lg, p: jl.categorical_td_loss(lg, jnp.asarray(actions), p),
        [logits, probs], [0, 1], _weights(rng))
    _close(got[0], want[0])
    # No gradient into the target distribution, in either package.
    assert not np.asarray(want[1]).any() and not got[1].any()


def test_quantile_midpoints_and_selection_exact():
    for n in (1, 11, 200):
        np.testing.assert_array_equal(tl.quantile_midpoints(n).numpy(),
                                      jl.quantile_midpoints(n))
    rng = _rng(5)
    online = rng.normal(size=(B, A, M)).astype(np.float32)
    target = rng.normal(size=(B, A, M)).astype(np.float32)
    online[0] = 0.0                             # ties: first index wins
    np.testing.assert_array_equal(
        tl.quantile_double_q_select(_t(online), _t(target)).numpy(),
        jl.quantile_double_q_select(jnp.asarray(online),
                                    jnp.asarray(target)))


@pytest.mark.parametrize("kappa", [1.0, 0.5])
def test_quantile_huber_td_values_and_gradients(kappa):
    rng = _rng(6)
    theta = (rng.normal(size=(B, M)) * 2).astype(np.float32)
    target = (rng.normal(size=(B, 2 * M)) * 2).astype(np.float32)
    _close(tl.quantile_huber_td(_t(theta), _t(target), kappa),
           jl.quantile_huber_td(jnp.asarray(theta), jnp.asarray(target),
                                kappa))
    got, want = _grads(lambda th, tg: tl.quantile_huber_td(th, tg, kappa),
                       lambda th, tg: jl.quantile_huber_td(th, tg, kappa),
                       [theta, target], [0, 1], _weights(rng))
    _close(got[0], want[0])
    assert not np.asarray(want[1]).any() and not got[1].any()


@pytest.mark.parametrize("kappa", [1.0, 0.5])
def test_iqn_quantile_huber_td_values_and_gradients(kappa):
    rng = _rng(7)
    theta = (rng.normal(size=(B, 8)) * 2).astype(np.float32)
    taus = rng.uniform(size=(B, 8)).astype(np.float32)
    target = (rng.normal(size=(B, 6)) * 2).astype(np.float32)
    _close(tl.iqn_quantile_huber_td(_t(theta), _t(taus), _t(target), kappa),
           jl.iqn_quantile_huber_td(jnp.asarray(theta), jnp.asarray(taus),
                                    jnp.asarray(target), kappa))
    got, want = _grads(
        lambda th, ta, tg: tl.iqn_quantile_huber_td(th, ta, tg, kappa),
        lambda th, ta, tg: jl.iqn_quantile_huber_td(th, ta, tg, kappa),
        [theta, taus, target], [0, 1, 2], _weights(rng))
    _close(got[0], want[0])
    for i in (1, 2):          # taus and targets are stop-gradded
        assert not np.asarray(want[i]).any() and not got[i].any()


def test_iqn_loss_at_midpoints_is_the_qr_loss():
    rng = _rng(8)
    theta = rng.normal(size=(B, M)).astype(np.float32)
    target = rng.normal(size=(B, M)).astype(np.float32)
    mids = tl.quantile_midpoints(M)[None, :].expand(B, M)
    np.testing.assert_array_equal(
        tl.iqn_quantile_huber_td(_t(theta), mids, _t(target)).numpy(),
        tl.quantile_huber_td(_t(theta), _t(target)).numpy())
