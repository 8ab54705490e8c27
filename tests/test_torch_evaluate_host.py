"""``evaluate --host-env`` of the port (dist_dqn_tpu_torch/evaluate.py
``evaluate_checkpoint_host``) against dist_dqn_tpu/evaluate.py on the CPU:
the same JAX weights, restored from a port checkpoint on one side and
handed to JAX's evaluator on the other, play CartPole-v1 greedily
(``epsilon=0``) to the same returns, exactly; with ``member`` on a
population checkpoint too. Then the CLI's host branch on the fake ALE."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu import evaluate as jev
from dist_dqn_tpu.models import build_network as jax_build
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import evaluate as ev
from dist_dqn_tpu_torch.agents.dqn import make_learner
from dist_dqn_tpu_torch.models import build_network, stack_networks
from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                 record_population_size)
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import to_numpy_tree

pytest.importorskip("gymnasium")

_NET = ["network.torso=mlp", "network.mlp_features=(32,)",
        "network.hidden=16", "network.compute_dtype=float32"]


def _cfgs():
    return (tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], _NET),
            jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], _NET))


def _jax_params(cfg, seed):
    jnet = jax_build(cfg.network, 2)
    return jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4)))


def _port_net(tcfg, params):
    net = build_network(tcfg.network, 2, (4,), device="cpu", seed=1)
    net.load_state_dict(from_flax(to_numpy_tree(params), net))
    return net


@dataclasses.dataclass
class _Stacked:
    """A population learner's checkpoint layout: the [M]-stacked net."""
    net: object


def _their_returns(monkeypatch, jcfg, params, **kw):
    """JAX's evaluate_checkpoint_host with its restore replaced by the
    given params (JAX cannot read a port checkpoint)."""
    def restore(directory, example, step=None, member=None):
        assert jax.tree.structure(example) == jax.tree.structure(params)
        return 7, params

    monkeypatch.setattr(jev, "_restore_latest", restore)
    return jev.evaluate_checkpoint_host(jcfg, "unused", "CartPole-v1", **kw)


def test_host_eval_plays_like_jax(tmp_path, monkeypatch):
    tcfg, jcfg = _cfgs()
    params = _jax_params(jcfg, 3)
    d = str(tmp_path / "solo")
    init, _ = make_learner(tcfg.learner, _port_net(tcfg, params))
    TrainCheckpointer(d).save(7, init(_port_net(tcfg, params)))
    kw = dict(episodes=4, seed=2, epsilon=0.0)
    ours = ev.evaluate_checkpoint_host(tcfg, d, "CartPole-v1", device="cpu",
                                       **kw)
    theirs = _their_returns(monkeypatch, jcfg, params, **kw)
    assert ours == theirs
    assert ours["frames"] == 7 and ours["host_env"] == "CartPole-v1"
    assert 1.0 <= ours["eval_return"] <= 500.0


def test_host_eval_of_a_population_member_plays_like_jax(tmp_path,
                                                         monkeypatch):
    tcfg, jcfg = _cfgs()
    members = [_jax_params(jcfg, s) for s in (4, 5)]
    d = str(tmp_path / "pop")
    stacked = stack_networks([_port_net(tcfg, p) for p in members])
    TrainCheckpointer(d).save(7, _Stacked(stacked))
    record_population_size(d, 2)
    kw = dict(episodes=3, seed=1, epsilon=0.0)
    for k in (0, 1):
        ours = ev.evaluate_checkpoint_host(tcfg, d, "CartPole-v1",
                                           device="cpu", member=k, **kw)
        theirs = _their_returns(monkeypatch, jcfg, members[k], member=k,
                                **kw)
        assert ours == theirs and ours["member"] == k
    with pytest.raises(ValueError, match="population-2"):
        ev.evaluate_checkpoint_host(tcfg, d, "CartPole-v1", device="cpu",
                                    **kw)


def test_cli_host_env_on_the_fake_ale(tmp_path, monkeypatch, capsys):
    """``--host-env ale:Breakout`` under ``DQN_FAKE_ALE=1``: the network
    takes the host env's 4 actions and episodes are whole games with raw
    scores; ``max_steps`` of ``evaluate_checkpoint_host`` caps them."""
    monkeypatch.setenv("DQN_FAKE_ALE", "1")
    small = ["network.torso=small", "network.hidden=32",
             "network.compute_dtype=float32"]
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["atari"], small)
    net = build_network(cfg.network, 4, (84, 84, 4), device="cpu", seed=0)
    d = str(tmp_path / "Breakout")
    init, _ = make_learner(cfg.learner, net)
    TrainCheckpointer(d).save(1, init(net))
    argv = ["--config", "atari", "--device", "cpu", "--checkpoint-dir", d,
            "--host-env", "ale:Breakout", "--episodes", "2"]
    for a in small:
        argv += ["--set", a]
    ev.main(argv)
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["host_env"] == "ale:Breakout" and row["frames"] == 1
    assert row["episodes"] == 2 and row["episodes_truncated"] == 0
    assert np.isfinite(row["eval_return"])
    capped = ev.evaluate_checkpoint_host(cfg, d, "ale:Breakout", episodes=2,
                                         max_steps=30, device="cpu")
    assert capped["episodes"] == 2 and capped["episodes_truncated"] == 2
    with pytest.raises(SystemExit):
        ev.main(argv + ["--export-params", str(tmp_path / "p")])
    # The action count comes from the host env: Pong's 6-action net does
    # not take Breakout's 4-action checkpoint.
    with pytest.raises(ValueError, match="network structure"):
        ev.evaluate_checkpoint_host(cfg, d, "ale:Pong", episodes=1,
                                    max_steps=2, device="cpu")


def test_cli_host_env_walks_every_retained_step(tmp_path, capsys):
    """``--host-env --all-steps``: one row per retained step, oldest first,
    each restored through the single-point surface."""
    tcfg, jcfg = _cfgs()
    d = str(tmp_path / "run")
    ckpt = TrainCheckpointer(d)
    for step, seed in ((100, 6), (200, 7)):
        net = _port_net(tcfg, _jax_params(jcfg, seed))
        ckpt.save(step, make_learner(tcfg.learner, net)[0](net))
    argv = ["--config", "cartpole", "--device", "cpu", "--checkpoint-dir", d,
            "--host-env", "CartPole-v1", "--all-steps", "--episodes", "2"]
    for a in _NET:
        argv += ["--set", a]
    ev.main(argv)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["frames"] for r in rows] == [100, 200]
    assert all(r["host_env"] == "CartPole-v1" and 1.0 <= r["eval_return"]
               <= 500.0 for r in rows)
