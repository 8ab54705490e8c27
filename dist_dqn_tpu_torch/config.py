"""Configuration system: the port's own copy of ``dist_dqn_tpu/config.py``.

The five baseline configs (BASELINE.json:7-11) plus three beyond-spec
presets (qrdqn, iqn, mdqn), field for field the same as the JAX
package's (pinned by tests/test_torch_models.py). The port imports nothing
of ``dist_dqn_tpu``, so it keeps this copy instead of sharing the module.

Frozen dataclasses so configs are hashable. ``CONFIGS`` is the registry
keyed by the names the train CLI accepts. Derive variants with
``dataclasses.replace`` or the CLI's ``--set`` flag (``apply_overrides``).
Fields the port does not implement yet are refused by the entry points
that would read them (train.py), never ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Q-network architecture knobs (models/qnets.py, models/recurrent.py)."""

    torso: str = "nature"  # "mlp" | "nature" (84x84 Atari CNN) | "small"
    #                        (cheap 84x84 CNN — models/qnets.py presets)
    mlp_features: Tuple[int, ...] = (256, 256)
    hidden: int = 512                  # post-torso embedding width
    dueling: bool = False              # dueling value/advantage streams
    noisy: bool = False                # NoisyNet exploration heads (Rainbow)
    num_atoms: int = 1                 # >1 => distributional head (C51/QR)
    v_min: float = -10.0
    v_max: float = 10.0
    quantile: bool = False             # num_atoms>1: QR-DQN instead of C51
    # IQN (Dabney et al., 2018b) — the third distributional family: the
    # head is CONDITIONED on sampled quantile fractions via a cosine
    # embedding instead of outputting a fixed set (models/qnets.py
    # ImplicitQuantileNetwork). Mutually exclusive with noisy /
    # num_atoms>1 / lstm_size.
    iqn: bool = False
    iqn_embed_dim: int = 64            # cosine embedding width
    iqn_tau_samples: int = 64          # N: online tau draws per loss
    iqn_tau_target_samples: int = 64   # N': target tau draws per loss
    iqn_tau_act: int = 32              # K: fixed acting fractions
    # Acting-time risk distortion: q_values averages the lower
    # risk_cvar_eta tail of the return distribution (CVaR_eta); 1.0 is
    # the risk-neutral mean.
    risk_cvar_eta: float = 1.0
    lstm_size: int = 0                 # >0 => recurrent core (R2D2)
    remat_torso: bool = False          # recompute torso acts in backward
    compute_dtype: str = "float32"     # "bfloat16": per-layer bf16 compute
    # R2D2 learner-throughput knobs (models/recurrent.py): gate-matmul
    # dtype of the LSTM cell (carry stays float32 either way) and the
    # lax.scan unroll factor of the time loop (XLA fuses k cell steps per
    # scan iteration; the math is unchanged).
    lstm_dtype: str = "float32"        # "bfloat16" runs cell matmuls on MXU
    lstm_unroll: int = 1
    # Actor/learner dtype split: "bfloat16" casts the params
    # ONCE per chunk for actor inference (acting reads a bf16 snapshot
    # of the chunk-entry params — one target-network's worth of extra
    # staleness, Podracer-style) while the learner keeps fp32 master
    # params end to end. "float32" (default) acts on the live learner
    # params exactly as before — bit-identical, pinned by the
    # param_checksum A/B in tests/test_replay_ratio.py.
    actor_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Replay buffer knobs (replay/)."""

    capacity: int = 100_000
    prioritized: bool = False
    priority_exponent: float = 0.6     # alpha
    importance_exponent: float = 0.4   # beta (annealed -> 1.0 over training)
    priority_eps: float = 1e-6
    min_fill: int = 1_000              # learning starts after this many items
    pallas_sampler: bool = False       # hand-written sampler kernel (ops/sampler.py)
    # Store the pre-reset successor obs alongside each step so n-step windows
    # bootstrap exactly through time-limit truncation. None = auto: on for
    # cheap (non-uint8) observations, off for pixel rings, where the second
    # obs copy would double HBM and truncation is treated as terminal.
    store_final_obs: "bool | None" = None
    # Store multi-dim obs FLAT in the device ring ([slots * B, prod]).
    # None = auto: flat only when the ring's logical bytes exceed ~2 GB
    # (loop_common.resolve_flat_storage). The JAX package chose this to
    # dodge XLA tile padding; the port keeps the rule so both packages
    # lay a config's ring out the same way.
    flat_storage: "bool | None" = None
    # Frame-dedup storage for rolling-stack pixel obs (fused loop only):
    # store each step's NEWEST frame instead of the whole stack and
    # rebuild stacks at sample time from frame_stack consecutive slots
    # (exact, including reset-boundary re-tiling — replay/device.py
    # stack_rebuild_indices). A 4x saving of ring memory on Atari
    # stacks. Requires the
    # env to declare the rolling-stack contract (TorchEnv.frame_stack > 0)
    # and store_final_obs off. Covers BOTH fused loops: the feedforward
    # ring (replay/device.py) and the R2D2 sequence ring
    # (replay/sequence_device.py _rebuild_seq_stacks).
    frame_dedup: bool = False
    # On-device replay ratio (--replay-ratio): grad sub-steps
    # per train event, each drawing an INDEPENDENT replay batch from a
    # fresh RNG split, scanned inside the jitted chunk program (fused
    # loop) / one scanned device dispatch (apex) / one prefetched run
    # of batches (host-replay). Multiplies updates_per_train; 1 is
    # bit-identical to the pre-knob program (the train-event scan has
    # the same length and key stream), and with UNIFORM replay ratio N
    # == updates_per_train=N bit-for-bit. Under PER with ratio > 1 the
    # sub-steps' |TD| write-backs are deferred and flushed ONCE per
    # event with chronological last-wins semantics,
    # so sub-steps sample against event-entry priorities — the same lag
    # contract as the host loops' prio_writeback_batch.
    updates_per_chunk: int = 1
    # Wide train batches: 0 = learner.batch_size unchanged;
    # > 0 widens the train-event batch to this many rows, rounded UP to
    # the next power of two (the ingest bucket discipline — bounded
    # compile variants, MXU-friendly tiles). Sized empirically with
    # benchmarks/learner_bench.py --batch-sweep.
    train_batch: int = 0
    # R2D2 sequence replay (>0 enables sequence mode):
    burn_in: int = 0
    unroll_length: int = 0
    sequence_stride: int = 0           # overlap between stored sequences
    priority_mix: float = 0.9          # eta: p = eta*max|td| + (1-eta)*mean


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    """Optimizer / TD-learning knobs (agents/)."""

    learning_rate: float = 1e-3
    adam_eps: float = 1e-8
    # Learning-rate schedule over GRAD steps, counted by the optimizer's
    # own state (survives checkpoint/resume): "constant" ignores the
    # other two knobs; "linear" anneals learning_rate -> lr_end_value
    # over lr_decay_steps; "cosine" decays along a half-cosine to
    # lr_end_value and holds there.
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0
    lr_end_value: float = 0.0
    gamma: float = 0.99
    n_step: int = 1
    batch_size: int = 128
    double_dqn: bool = True
    huber_delta: float = 1.0
    max_grad_norm: float = 10.0        # 0 disables clipping
    # Target network sync (BASELINE.json:5 "target-network Polyak sync"):
    target_update_period: int = 500    # hard copy every N steps (if tau == 0)
    target_tau: float = 0.0            # >0 => soft Polyak every step
    value_rescale: bool = False        # R2D2 h/h^-1 transform
    # Munchausen-DQN (Vieillard et al., 2020): entropy-regularized soft
    # bootstrap plus a clipped scaled log-policy bonus on the reward.
    # Scalar-head only (agents/dqn.py); replaces the max/double-Q
    # bootstrap when set. Use with n_step=1: replay folds n-step rewards
    # at sample time, so the intermediate per-step log-policy bonuses
    # the telescoped soft recursion needs are not recoverable — with
    # n_step>1 only the first step's bonus is applied (make_learner
    # rejects the combination rather than silently approximating).
    munchausen: bool = False
    munchausen_alpha: float = 0.9      # bonus scale
    munchausen_tau: float = 0.03       # entropy temperature
    munchausen_clip: float = -1.0      # lower clip l0 on log pi(a|s)


@dataclasses.dataclass(frozen=True)
class ActorConfig:
    """Rollout / exploration knobs (actors/, train loops)."""

    num_envs: int = 16                 # vectorized envs per actor process
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 10_000
    # Ape-X per-actor epsilon ladder: eps_i = base ** (1 + i/(N-1) * alpha)
    apex_epsilon_base: float = 0.4
    apex_epsilon_alpha: float = 7.0
    num_actors: int = 1                # actor processes (Ape-X: e.g. 256)


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """Population training plane (fused runtime only).

    ``size`` M > 1 vmap-stacks M independent policies — params, optimizer
    state, target params, replay and collect carries all gain a leading
    member axis — and advances all of them in ONE dispatched chunk
    program per chunk (Podracer's "one program, many policies",
    PAPERS.md). ``spec_json`` optionally carries per-member
    hyperparameter vectors (``epsilon`` / ``lr`` / ``gamma``, each a
    length-M JSON array — the raw text of the ``--population-spec``
    file; dist_dqn_tpu/population.py parses and validates it). size=1
    runs the exact pre-knob program (bit-identity pin,
    tests/test_population.py).
    """

    size: int = 1
    spec_json: str = ""


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One runnable experiment = env + net + replay + learner + actors."""

    name: str
    env_name: str                      # key into envs.make()
    network: NetworkConfig = NetworkConfig()
    replay: ReplayConfig = ReplayConfig()
    learner: LearnerConfig = LearnerConfig()
    actor: ActorConfig = ActorConfig()
    population: PopulationConfig = PopulationConfig()
    total_env_steps: int = 500_000
    train_every: int = 1               # learner updates per env *vector* step
    updates_per_train: int = 1
    eval_every_steps: int = 25_000
    eval_episodes: int = 10
    seed: int = 0


# ---------------------------------------------------------------------------
# The five baseline configs (BASELINE.json:7-11), one entry each.
# ---------------------------------------------------------------------------

CARTPOLE = ExperimentConfig(
    # BASELINE.json:7 — "CartPole-v1 single-process DQN (CPU ref)"
    name="cartpole",
    env_name="cartpole",
    network=NetworkConfig(torso="mlp", mlp_features=(256, 256), hidden=0),
    replay=ReplayConfig(capacity=50_000, min_fill=1_000),
    learner=LearnerConfig(
        learning_rate=1e-3, gamma=0.99, n_step=3, batch_size=128,
        target_update_period=250,
    ),
    actor=ActorConfig(num_envs=16, epsilon_decay_steps=20_000),
    total_env_steps=400_000,
)

ATARI = ExperimentConfig(
    # BASELINE.json:8 — "Atari Pong/Breakout DQN (Nature CNN, 1 chip)"
    name="atari",
    env_name="pixel_pong",             # synthetic offline stand-in; real ALE
    network=NetworkConfig(torso="nature", hidden=512,
                          compute_dtype="bfloat16"),
    replay=ReplayConfig(capacity=200_000, min_fill=20_000),
    learner=LearnerConfig(
        learning_rate=6.25e-5, adam_eps=1.5e-4, gamma=0.99, n_step=3,
        batch_size=256, target_update_period=2_000,
    ),
    actor=ActorConfig(num_envs=64, epsilon_decay_steps=250_000),
    total_env_steps=10_000_000,
    train_every=4,
)

APEX = ExperimentConfig(
    # BASELINE.json:9 — "Ape-X DQN: 256 CPU actors + sharded learner on mesh"
    name="apex",
    env_name="pixel_pong",
    network=NetworkConfig(torso="nature", hidden=512, dueling=True,
                          compute_dtype="bfloat16"),
    replay=ReplayConfig(capacity=1_000_000, prioritized=True,
                        priority_exponent=0.6, importance_exponent=0.4,
                        min_fill=50_000,
                        # ~1M-cell priority plane: drawn by the
                        # hand-written sampler kernel (ops/sampler.py).
                        pallas_sampler=True),
    learner=LearnerConfig(
        learning_rate=1e-4, adam_eps=1.5e-4, gamma=0.99, n_step=3,
        batch_size=512, double_dqn=True, target_update_period=2_500,
    ),
    actor=ActorConfig(num_envs=16, num_actors=256),
    total_env_steps=100_000_000,
)

R2D2 = ExperimentConfig(
    # BASELINE.json:10 — "R2D2 recurrent DQN (LSTM Q-net, seq replay, burn-in)"
    name="r2d2",
    env_name="pixel_pong",
    network=NetworkConfig(torso="nature", hidden=512, dueling=True,
                          lstm_size=512, compute_dtype="bfloat16",
                          # Throughput knobs of the JAX package's
                          # recurrent learner (models/recurrent.py). The
                          # port honours remat_torso and lstm_dtype;
                          # lstm_unroll is scan scheduling there and
                          # changes nothing here.
                          remat_torso=False,
                          lstm_dtype="bfloat16", lstm_unroll=8),
    replay=ReplayConfig(capacity=100_000, prioritized=True,
                        priority_exponent=0.9, importance_exponent=0.6,
                        burn_in=40, unroll_length=80, sequence_stride=40,
                        min_fill=2_500),
    learner=LearnerConfig(
        learning_rate=1e-4, adam_eps=1e-3, gamma=0.997, n_step=5,
        batch_size=64, double_dqn=True, target_update_period=2_500,
        value_rescale=True,
    ),
    actor=ActorConfig(num_envs=16, num_actors=256),
    total_env_steps=100_000_000,
)

RAINBOW = ExperimentConfig(
    # BASELINE.json:11 — "Rainbow / C51 distributional DQN on DM-Control pixels"
    name="rainbow",
    env_name="dmc_pixels",             # synthetic pixel env offline fallback
    network=NetworkConfig(torso="nature", hidden=512, dueling=True,
                          noisy=True, num_atoms=51, v_min=-10.0, v_max=10.0,
                          compute_dtype="bfloat16"),
    replay=ReplayConfig(capacity=200_000, prioritized=True,
                        priority_exponent=0.5, importance_exponent=0.4,
                        min_fill=20_000),
    learner=LearnerConfig(
        learning_rate=6.25e-5, adam_eps=1.5e-4, gamma=0.99, n_step=3,
        batch_size=256, double_dqn=True, target_update_period=2_000,
    ),
    actor=ActorConfig(num_envs=64, epsilon_start=0.0, epsilon_end=0.0),
    total_env_steps=10_000_000,
    train_every=4,
)

QRDQN = ExperimentConfig(
    # Beyond the five baseline configs: QR-DQN (Dabney et al., 2018) — the
    # quantile-regression distributional family on the Atari-shaped path,
    # sharing the atari preset's schedule with the standard 200-quantile
    # head (no fixed support, so no v_min/v_max tuning).
    name="qrdqn",
    env_name="pixel_pong",
    network=NetworkConfig(torso="nature", hidden=512, num_atoms=200,
                          quantile=True, compute_dtype="bfloat16"),
    replay=ReplayConfig(capacity=200_000, prioritized=True,
                        priority_exponent=0.5, importance_exponent=0.4,
                        min_fill=20_000),
    learner=LearnerConfig(
        learning_rate=5e-5, adam_eps=3.125e-4, gamma=0.99, n_step=3,
        batch_size=256, double_dqn=True, target_update_period=2_000,
        huber_delta=1.0,
    ),
    actor=ActorConfig(num_envs=64, epsilon_decay_steps=250_000),
    total_env_steps=10_000_000,
    train_every=4,
)

IQN = ExperimentConfig(
    # Beyond the five baseline configs: IQN (Dabney et al., 2018b) — the
    # implicit-quantile distributional family on the Atari-shaped path.
    # Shares the qrdqn preset's schedule; the head samples 64 online /
    # 64 target quantile fractions per loss and acts on 32 fixed
    # fractions (risk-neutral by default; set network.risk_cvar_eta < 1
    # for CVaR risk-averse control).
    name="iqn",
    env_name="pixel_pong",
    network=NetworkConfig(torso="nature", hidden=512, iqn=True,
                          compute_dtype="bfloat16"),
    replay=ReplayConfig(capacity=200_000, prioritized=True,
                        priority_exponent=0.5, importance_exponent=0.4,
                        min_fill=20_000),
    learner=LearnerConfig(
        learning_rate=5e-5, adam_eps=3.125e-4, gamma=0.99, n_step=3,
        batch_size=256, double_dqn=True, target_update_period=2_000,
        huber_delta=1.0,
    ),
    actor=ActorConfig(num_envs=64, epsilon_decay_steps=250_000),
    total_env_steps=10_000_000,
    train_every=4,
)

MDQN = ExperimentConfig(
    # Beyond the five baseline configs: Munchausen-DQN (Vieillard et
    # al., 2020) — the atari preset's schedule with the soft
    # entropy-regularized bootstrap and the clipped log-policy reward
    # bonus (paper defaults alpha 0.9, tau 0.03, l0 -1) plus PER.
    name="mdqn",
    env_name="pixel_pong",
    network=NetworkConfig(torso="nature", hidden=512,
                          compute_dtype="bfloat16"),
    replay=ReplayConfig(capacity=200_000, prioritized=True,
                        priority_exponent=0.5, importance_exponent=0.4,
                        min_fill=20_000),
    learner=LearnerConfig(
        # n_step=1: the Munchausen recursion needs every step's
        # log-policy bonus, which folded n-step rewards can't carry
        # (see LearnerConfig.munchausen).
        learning_rate=6.25e-5, adam_eps=1.5e-4, gamma=0.99, n_step=1,
        # double_dqn is superseded by the soft bootstrap (there is no
        # argmax to decouple); the learner rejects the combination.
        batch_size=256, double_dqn=False, target_update_period=2_000,
        munchausen=True,
    ),
    actor=ActorConfig(num_envs=64, epsilon_decay_steps=250_000),
    total_env_steps=10_000_000,
    train_every=4,
)

CONFIGS: Dict[str, ExperimentConfig] = {
    c.name: c for c in (CARTPOLE, ATARI, APEX, R2D2, RAINBOW, QRDQN, IQN,
                        MDQN)
}


# ---------------------------------------------------------------------------
# Generic dotted-path config overrides (the CLIs' --set flag): derive any
# preset variant from the command line without writing a config file —
# the CLI counterpart of the dataclasses.replace idiom used in code.
# ---------------------------------------------------------------------------

def _coerce(raw: str, current, path: str):
    """Parse ``raw`` to the type of the field's current value."""
    low = raw.lower()
    if isinstance(current, bool):          # bool before int: bool is an int
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"--set {path}: expected a bool, got {raw!r}")
    if isinstance(current, int):
        try:
            return int(raw, 0)
        except ValueError:
            # Common spellings with unambiguous intent: 1e6, 2.5e5,
            # 200_000 (int() already takes underscores; the float path
            # catches scientific notation). Accept only values that are
            # exactly integral — 1.5 stays an error.
            import math

            try:
                as_float = float(raw)
            except ValueError:
                as_float = None
            if (as_float is not None and math.isfinite(as_float)
                    and as_float == int(as_float)):
                return int(as_float)
            raise ValueError(
                f"--set {path}: expected an int (decimal, hex, or an "
                f"exactly-integral form like 1e6 / 200_000), got "
                f"{raw!r}") from None
    if isinstance(current, float):
        try:
            return float(raw)
        except ValueError:
            raise ValueError(
                f"--set {path}: expected a float, got {raw!r}") from None
    if isinstance(current, tuple):
        items = [s for s in raw.strip("()").split(",") if s.strip()]
        elem = current[0] if current else 0
        return tuple(_coerce(s.strip(), elem, path) for s in items)
    if isinstance(current, str):
        return raw
    # Optional fields default to None (e.g. replay.store_final_obs);
    # accept none/bool and fall back through int/float to str.
    if current is None:
        if low in ("none", "null"):
            return None
        if low in ("true", "false", "1", "0", "yes", "no", "on", "off"):
            return _coerce(raw, True, path)
        for parse in (int, float):
            try:
                return parse(raw)
            except ValueError:
                pass
        return raw
    raise ValueError(
        f"--set {path}: field type {type(current).__name__} is not "
        "overridable from the command line")


def _is_optional(cls, name: str) -> bool:
    """True if the resolved annotation of ``cls.name`` admits None
    (covers both the ``X | None`` and ``Optional[X]`` spellings)."""
    import typing

    try:
        hint = typing.get_type_hints(cls).get(name)
    except Exception:
        return False
    return type(None) in typing.get_args(hint)


def _set_path(obj, keys, raw: str, path: str):
    if not dataclasses.is_dataclass(obj):
        raise ValueError(f"--set {path}: {keys[0]!r} is past a leaf field")
    names = {f.name for f in dataclasses.fields(obj)}
    name = keys[0]
    if name not in names:
        raise ValueError(
            f"--set {path}: unknown field {name!r}; valid here: "
            f"{', '.join(sorted(names))}")
    current = getattr(obj, name)
    if len(keys) == 1:
        if dataclasses.is_dataclass(current):
            sub = ", ".join(
                f.name for f in dataclasses.fields(current))
            raise ValueError(
                f"--set {path}: {name!r} is a config section; set one of "
                f"its fields ({sub})")
        # Optional fields (resolved annotation admits None) accept
        # "none" regardless of their current value's type.
        if raw.lower() in ("none", "null") and _is_optional(type(obj),
                                                            name):
            return dataclasses.replace(obj, **{name: None})
        return dataclasses.replace(obj, **{name: _coerce(raw, current,
                                                         path)})
    return dataclasses.replace(
        obj, **{name: _set_path(current, keys[1:], raw, path)})


def apply_overrides(cfg: ExperimentConfig, assignments) -> ExperimentConfig:
    """Apply ``--set dotted.path=value`` assignments to a config.

    e.g. apply_overrides(CONFIGS["atari"], ["network.dueling=true",
    "learner.batch_size=64", "replay.capacity=65536"]). Values are
    coerced to the field's current type (tuples parse "256,256");
    unknown fields and section-level assignments raise ValueError with
    the valid field names.
    """
    for a in assignments or ():
        path, eq, raw = a.partition("=")
        path = path.strip()
        if not eq or not path:
            raise ValueError(
                f"--set {a!r}: expected the form dotted.path=value")
        cfg = _set_path(cfg, path.split("."), raw.strip(), path)
    return cfg
