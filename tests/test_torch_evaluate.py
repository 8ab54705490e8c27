"""The port's standalone evaluation (dist_dqn_tpu_torch/evaluate.py) on the
CPU: one checkpoint and the ``--all-steps`` curve, the params-only restore
(optimizer-agnostic, carry-kind directories), ``--export-params``,
``--risk-cvar-eta``, the R2D2 branch, the refused flags, and the parity
that matters to a deploy: params restored from a port checkpoint of JAX
weights give the JAX network's Q-values (float32, atol 1e-5)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import evaluate as ev
from dist_dqn_tpu_torch.agents.dqn import make_learner
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.train import train
from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                 list_checkpoint_steps,
                                                 restore_pytree)
from dist_dqn_tpu_torch.utils.params import from_flax
from torch_parity import to_numpy_tree

QUIET = lambda line: None  # noqa: E731
CARTPOLE_TINY = ["network.mlp_features=(16,)", "replay.capacity=512",
                 "replay.min_fill=64", "learner.batch_size=16",
                 "actor.num_envs=4", "eval_every_steps=0"]


def _cartpole(*extra):
    return tconfig.apply_overrides(tconfig.CONFIGS["cartpole"],
                                   CARTPOLE_TINY + list(extra))


def test_evaluate_checkpoint_before_and_after_training(tmp_path):
    cfg = _cartpole()
    d = str(tmp_path / "run")
    with pytest.raises(FileNotFoundError):
        ev.evaluate_checkpoint(cfg, d, episodes=2, device="cpu")
    assert not os.path.exists(d)            # a read never creates the dir
    train(cfg, total_env_steps=600, chunk_iters=75, log_fn=QUIET,
          device="cpu", checkpoint_dir=d)
    out = ev.evaluate_checkpoint(cfg, d, episodes=4, seed=1, device="cpu")
    assert out["frames"] >= 600 and out["config"] == "cartpole"
    assert 1.0 <= out["eval_return"] <= 500.0
    # The same draws give the same return.
    again = ev.evaluate_checkpoint(cfg, d, episodes=4, seed=1, device="cpu")
    assert again["eval_return"] == out["eval_return"]


def test_all_steps_walks_the_curve_and_skips_a_deleted_step(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    cfg = _cartpole()
    d = str(tmp_path / "run")
    train(cfg, total_env_steps=900, chunk_iters=75, log_fn=QUIET,
          device="cpu", checkpoint_dir=d, save_every_frames=300)
    steps = list_checkpoint_steps(d)
    assert steps == (300, 600, 900)
    argv = ["--config", "cartpole", "--device", "cpu", "--checkpoint-dir", d,
            "--episodes", "1", "--all-steps"]
    for a in CARTPOLE_TINY:
        argv += ["--set", a]
    ev.main(argv)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["frames"] for r in rows] == list(steps)
    assert all(1.0 <= r["eval_return"] <= 500.0 for r in rows)

    # A live run's retention deletes step 600 after the walk listed it.
    real = TrainCheckpointer.restore_params

    def racing(self, example, step=None, prefix=(), member=None):
        if step == 600:
            self.delete(600)
        return real(self, example, step=step, prefix=prefix, member=member)

    monkeypatch.setattr(TrainCheckpointer, "restore_params", racing)
    ev.main(argv)
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["frames"] for r in rows] == [300, 600, 900]
    assert "skipped" in rows[1] and "eval_return" not in rows[1]
    assert "eval_return" in rows[0] and "eval_return" in rows[2]


def test_evaluate_is_optimizer_agnostic_and_exports_params(tmp_path):
    """A cosine-lr run evaluates under a constant-lr config (only the
    params are read), and ``--export-params`` round-trips bit-equal."""
    scheduled = _cartpole("learner.lr_schedule=cosine",
                          "learner.lr_decay_steps=100",
                          "learner.lr_end_value=1e-5")
    d = str(tmp_path / "run")
    train(scheduled, total_env_steps=300, chunk_iters=75, log_fn=QUIET,
          device="cpu", checkpoint_dir=d)
    plain = _cartpole()
    out = ev.evaluate_checkpoint(plain, d, episodes=2, device="cpu")
    assert out["frames"] == 300 and 1.0 <= out["eval_return"] <= 500.0

    export = str(tmp_path / "deploy_params")
    argv = ["--config", "cartpole", "--device", "cpu", "--checkpoint-dir", d,
            "--episodes", "2", "--export-params", export]
    for a in CARTPOLE_TINY:
        argv += ["--set", a]
    ev.main(argv)
    net, _, _ = ev._build_eval(plain, 2, 0.001, 5, "cpu")
    reloaded = restore_pytree(export, net)
    direct, _, _ = ev._build_eval(plain, 2, 0.001, 6, "cpu")
    _, direct = TrainCheckpointer(d).restore_params(direct)
    for (name, a), b in zip(reloaded.state_dict().items(),
                            direct.state_dict().values()):
        assert torch.equal(a, b), name


def _iqn_cfg(**network):
    cfg = tconfig.CONFIGS["iqn"]
    return dataclasses.replace(
        cfg, env_name="cartpole",
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(16,), hidden=0,
                                    iqn_embed_dim=8, iqn_tau_samples=4,
                                    iqn_tau_target_samples=4, iqn_tau_act=4,
                                    compute_dtype="float32", **network),
        replay=dataclasses.replace(cfg.replay, capacity=512, min_fill=64,
                                   pallas_sampler=False),
        learner=dataclasses.replace(cfg.learner, batch_size=16),
        actor=dataclasses.replace(cfg.actor, num_envs=4),
        eval_every_steps=0, train_every=1)


def test_risk_cvar_eta_swaps_the_profile(tmp_path, capsys):
    cfg = _iqn_cfg()
    d = str(tmp_path / "run")
    train(cfg, total_env_steps=300, chunk_iters=75, log_fn=QUIET,
          device="cpu", checkpoint_dir=d)
    averse_cfg = ev._apply_risk_eta(cfg, 0.3)
    for c in (cfg, averse_cfg):
        out = ev.evaluate_checkpoint(c, d, episodes=2, seed=1, device="cpu")
        assert 1.0 <= out["eval_return"] <= 500.0
    assert averse_cfg.network.risk_cvar_eta == 0.3
    neutral = build_network(cfg.network, 2, (4,), device="cpu").act_taus()
    averse = build_network(averse_cfg.network, 2, (4,),
                           device="cpu").act_taus()
    np.testing.assert_allclose(averse.numpy(), neutral.numpy() * 0.3,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="IQN"):
        ev._apply_risk_eta(_cartpole(), 0.3)
    # The CLI tags its row with the eta it played.
    argv = ["--config", "iqn", "--device", "cpu", "--checkpoint-dir", d,
            "--episodes", "1", "--risk-cvar-eta", "0.5",
            "--set", "env_name=cartpole", "--set", "network.torso=mlp",
            "--set", "network.mlp_features=(16,)", "--set", "network.hidden=0",
            "--set", "network.iqn_embed_dim=8", "--set",
            "network.iqn_tau_samples=4", "--set",
            "network.iqn_tau_target_samples=4", "--set",
            "network.iqn_tau_act=4", "--set", "network.compute_dtype=float32"]
    ev.main(argv)
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["risk_cvar_eta"] == 0.5 and np.isfinite(row["eval_return"])


def test_r2d2_and_carry_kind_directories_are_evaluable(tmp_path):
    r2d2 = tconfig.apply_overrides(tconfig.CONFIGS["r2d2"], [
        "env_name=cartpole", "network.torso=mlp",
        "network.mlp_features=(16,)", "network.hidden=0",
        "network.lstm_size=8", "network.compute_dtype=float32",
        "network.lstm_dtype=float32", "replay.capacity=512",
        "replay.min_fill=64", "replay.burn_in=2", "replay.unroll_length=4",
        "replay.sequence_stride=2", "learner.n_step=2",
        "learner.batch_size=16", "actor.num_envs=4", "eval_every_steps=0"])
    for cfg, replay in ((r2d2, False), (r2d2, True), (_cartpole(), True)):
        d = str(tmp_path / f"{cfg.name}_{replay}")
        train(cfg, total_env_steps=600, chunk_iters=75, log_fn=QUIET,
              device="cpu", checkpoint_dir=d, checkpoint_replay=replay,
              save_every_frames=300)
        out = ev.evaluate_checkpoint(cfg, d, episodes=2, device="cpu")
        assert out["frames"] == 600 and 1.0 <= out["eval_return"] <= 500.0
        rows = ev.evaluate_checkpoint_curve(cfg, d, episodes=1,
                                            device="cpu")
        assert [r["frames"] for r in rows] == [300, 600]


# ROADMAP.md items ported since their flags were refused here.
_PORTED_ITEMS = {"A8"}


@pytest.mark.parametrize("flag,reason", [
    # --host-env (A8) is ported: these two cases run one episode each
    # (CartPole-v1 truncates at 500 steps), on a solo and on a population
    # checkpoint.
    (["--host-env", "CartPole-v1"], "A8"),
    (["--host-env", "CartPole-v1", "--member", "0"], "A8"),
    (["--telemetry-port", "9100"], "A10"),
    (["--fleet-dir", "fleet"], "A10"),
])
def test_cli_refuses_unported_flags_with_the_reason(tmp_path, flag, reason,
                                                    capsys):
    argv = ["--config", "cartpole", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path), *flag]
    if reason not in _PORTED_ITEMS:
        with pytest.raises(SystemExit, match=f"not ported yet: .*{reason}"):
            ev.main(argv)
        return
    cfg = _cartpole()
    net = build_network(cfg.network, 2, (4,), device="cpu", seed=0)
    if "--member" in flag:
        from collections import namedtuple

        from dist_dqn_tpu_torch.models import stack_networks
        from dist_dqn_tpu_torch.utils.checkpoint import \
            record_population_size

        # A population run's checkpoint: its [M]-stacked net.
        saved = namedtuple("Saved", "net")(stack_networks([net, net]))
        record_population_size(str(tmp_path), 2)
    else:
        saved = make_learner(cfg.learner, net)[0](net)
    TrainCheckpointer(str(tmp_path)).save(5, saved)
    for a in CARTPOLE_TINY:
        argv += ["--set", a]
    ev.main(argv + ["--episodes", "1"])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["host_env"] == "CartPole-v1" and row["frames"] == 5
    assert row.get("member") == (0 if "--member" in flag else None)
    assert 1.0 <= row["eval_return"] <= 500.0


def test_wait_for_checkpoint_cli_fails_fast_on_an_empty_dir(tmp_path):
    with pytest.raises(ev.CheckpointMissingError):
        ev.main(["--config", "cartpole", "--device", "cpu",
                 "--checkpoint-dir", str(tmp_path)])


@pytest.mark.parametrize("head", ["dueling_mlp", "iqn"])
def test_restored_params_give_the_jax_q_values(tmp_path, head):
    from dist_dqn_tpu.models import build_network as jax_build

    if head == "iqn":
        netcfg = jconfig.NetworkConfig(
            torso="mlp", mlp_features=(32,), hidden=16, dueling=True,
            iqn=True, iqn_embed_dim=16, iqn_tau_samples=5,
            iqn_tau_target_samples=4, iqn_tau_act=8, risk_cvar_eta=0.5)
    else:
        netcfg = jconfig.NetworkConfig(torso="mlp", mlp_features=(32, 32),
                                       hidden=16, dueling=True)
    obs = np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32)
    jnet = jax_build(netcfg, 2)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(obs[:1]))
    tcfg = tconfig.NetworkConfig(**dataclasses.asdict(netcfg))
    src = build_network(tcfg, 2, (4,), device="cpu", seed=3)
    src.load_state_dict(from_flax(to_numpy_tree(params), src))
    init, _ = make_learner(tconfig.LearnerConfig(), src)
    d = str(tmp_path / "ckpt")
    TrainCheckpointer(d).save(7, init(src))
    fresh = build_network(tcfg, 2, (4,), device="cpu", seed=4)
    frames, net = ev._restore_latest(d, fresh)
    assert frames == 7
    want = jnet.apply(params, jnp.asarray(obs), method=jnet.q_values)
    with torch.no_grad():
        got = net.q_values(torch.from_numpy(obs)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
