"""Port parity of the batched-act packing
(dist_dqn_tpu_torch/actors/act_dispatch.py) against the JAX package's:
the same power-of-two buckets, padded batches, epsilon rows and splits
(exact), and the one bucket rule shared with ``replay/host.py`` and
``loop_common.py``."""
import numpy as np
import pytest

from dist_dqn_tpu.actors import act_dispatch as jad
from dist_dqn_tpu.replay.host import pad_pow2 as jax_pad_pow2
from dist_dqn_tpu_torch import loop_common
from dist_dqn_tpu_torch.actors import act_dispatch as tad
from dist_dqn_tpu_torch.replay import host as thost


def test_bucket_rule_is_the_jax_rule_everywhere():
    for n in range(0, 2100):
        want = jax_pad_pow2(n)
        assert tad.bucket_rows(n) == jad.bucket_rows(n) == want
        assert thost.pad_pow2(n) == loop_common.pad_pow2(n) == want


@pytest.mark.parametrize("rows", [[1], [8, 8, 8], [3, 5, 1, 7], [64] * 8])
@pytest.mark.parametrize("obs_shape,dtype", [((4,), np.float32),
                                             ((84, 84, 4), np.uint8)])
def test_pack_and_split_match_jax(rows, obs_shape, dtype):
    rng = np.random.default_rng(len(rows))
    obs = [rng.integers(0, 200, (r,) + obs_shape).astype(dtype)
           for r in rows]
    eps = [float(e) for e in rng.uniform(size=len(rows))]
    got = tad.pack_act_rows(obs, eps)
    want = jad.pack_act_rows(obs, eps)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == np.float32
    assert got[2:] == want[2:]
    padded = got[0].shape[0]
    assert padded == tad.bucket_rows(sum(rows))
    assert not got[0][sum(rows):].any() and not got[1][sum(rows):].any()
    values = rng.normal(size=padded)
    for g, w, o in zip(tad.split_rows(values, rows),
                       jad.split_rows(values, rows), obs):
        np.testing.assert_array_equal(g, w)
        assert g.shape[0] == o.shape[0]
