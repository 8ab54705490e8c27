"""Population training plane of the port: M stacked policies trained as
one program (twin of dist_dqn_tpu/population.py).

One policy leaves the card mostly idle: every trace of the fused loop
shows the host's launches, not the device, setting the pace. A
population trains M policies (distinct seeds and hyperparameter
variants) at once: every carry leaf (the nets' params, Adam's moments,
the target params, the replay ring, the env lanes, the chunk
accumulators) gains a leading member axis, and each launch of the hot
path (the network's forward and backward, the loss, Adam, the ring's
add and gathers, the PER draw through the sampler kernel and the
write-back) serves all M members at once. Only the random draws are M
small calls, one per member generator.

Member independence is the contract: member k of an M-run computes what
a solo run configured with member k's hyperparameters
(:func:`member_config`) and seeded with ``member_seeds(seed, M)[k]``
computes. Member k's generators are those that solo run builds
(``loop_common.generators``), and every draw has the solo run's shape
and order, so both draw the same numbers; the stacked arithmetic
(batched matmuls, grouped convolutions, per-member reductions) may sum
in another order than the solo kernels, so params agree to rounding
(tests/test_torch_population.py pins both).

The spec JSON (``--population-spec``) carries the per-member vectors: an
object with any of ``epsilon`` (the exploration floor epsilon_end),
``lr`` and ``gamma``, each a length-M array. Members without an
override inherit the base config's value.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from dist_dqn_tpu_torch.config import ExperimentConfig, PopulationConfig
from dist_dqn_tpu_torch.train_loop import MemberHP, make_fused_train

#: The spec's per-member vector keys, and the config field each one
#: overrides in a member's solo-equivalent run.
SPEC_KEYS = ("epsilon", "lr", "gamma")


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """Validated per-member hyperparameter vectors (None = inherit)."""

    epsilon: Optional[Tuple[float, ...]] = None
    lr: Optional[Tuple[float, ...]] = None
    gamma: Optional[Tuple[float, ...]] = None


def parse_spec(text: str, size: int) -> PopulationSpec:
    """Parse and validate a ``--population-spec`` JSON document.

    Accepts an object whose keys are a subset of :data:`SPEC_KEYS`, each
    a length-``size`` array of numbers. Empty text means no overrides.
    Raises ``ValueError`` naming the offending key on any shape or range
    violation, with the JAX package's texts.
    """
    if not text or not text.strip():
        return PopulationSpec()
    try:
        raw = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"population spec is not valid JSON: {e}") from e
    if not isinstance(raw, dict):
        raise ValueError(
            f"population spec must be a JSON object of per-member "
            f"vectors {SPEC_KEYS}, got {type(raw).__name__}")
    unknown = sorted(set(raw) - set(SPEC_KEYS))
    if unknown:
        raise ValueError(
            f"population spec has unknown keys {unknown}; supported "
            f"per-member vectors: {list(SPEC_KEYS)}")
    out = {}
    for key in SPEC_KEYS:
        if key not in raw:
            continue
        vec = raw[key]
        if not isinstance(vec, (list, tuple)) or not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in vec):
            raise ValueError(
                f"population spec {key!r} must be an array of numbers")
        if len(vec) != size:
            raise ValueError(
                f"population spec {key!r} has {len(vec)} entries for "
                f"--population {size}; each vector must be length M")
        vals = tuple(float(v) for v in vec)
        if key == "epsilon" and not all(0.0 <= v <= 1.0 for v in vals):
            raise ValueError(
                "population spec 'epsilon' entries must be in [0, 1] "
                "(the per-member exploration floor epsilon_end)")
        if key == "lr" and not all(v > 0.0 for v in vals):
            raise ValueError(
                "population spec 'lr' entries must be > 0")
        if key == "gamma" and not all(0.0 < v <= 1.0 for v in vals):
            raise ValueError(
                "population spec 'gamma' entries must be in (0, 1]")
        out[key] = vals
    return PopulationSpec(**out)


def resolve_spec(cfg: ExperimentConfig) -> PopulationSpec:
    """The config's spec, parsed against its own ``population.size``."""
    spec = parse_spec(cfg.population.spec_json, cfg.population.size)
    if spec.lr is not None and cfg.learner.lr_schedule != "constant":
        raise ValueError(
            "population spec 'lr' requires learner.lr_schedule="
            "'constant' (agents/dqn.py make_population_optimizer: the "
            "anneal horizon is not a stackable member axis)")
    return spec


def member_seeds(seed: int, size: int) -> List[int]:
    """Member k's base seed: ``SeedSequence(seed, spawn_key=(k,))``. A solo
    run seeded with ``seeds[k]`` draws exactly member k's numbers."""
    return [int(np.random.SeedSequence(seed, spawn_key=(k,))
                .generate_state(1)[0]) for k in range(size)]


def member_config(cfg: ExperimentConfig, spec: PopulationSpec,
                  k: int) -> ExperimentConfig:
    """Member k's solo-equivalent config: the base config with member k's
    spec overrides applied statically and the population section reset."""
    actor, learner = cfg.actor, cfg.learner
    if spec.epsilon is not None:
        actor = dataclasses.replace(actor, epsilon_end=spec.epsilon[k])
    if spec.lr is not None:
        learner = dataclasses.replace(learner, learning_rate=spec.lr[k])
    if spec.gamma is not None:
        learner = dataclasses.replace(learner, gamma=spec.gamma[k])
    return dataclasses.replace(cfg, actor=actor, learner=learner,
                               population=PopulationConfig())


def member_hp(cfg: ExperimentConfig, spec: PopulationSpec) -> MemberHP:
    """The stacked [M] float32 :class:`MemberHP` (CPU tensors; the loop
    moves them to its device). ``eps_delta`` folds epsilon_start -
    epsilon_end on the host in float64 and casts to float32, the constant
    the solo schedule computes (``loop_common._linear_schedule``), so a
    member's epsilon is the solo schedule's bit for bit. ``lr`` is None
    without an ``lr`` vector: the members then share the config's
    schedule."""
    M = cfg.population.size
    eps_end = (spec.epsilon if spec.epsilon is not None
               else (cfg.actor.epsilon_end,) * M)
    gamma = (spec.gamma if spec.gamma is not None
             else (cfg.learner.gamma,) * M)
    start = float(cfg.actor.epsilon_start)

    def f32(values):
        return torch.from_numpy(np.asarray(values, dtype=np.float32))

    return MemberHP(
        eps_delta=f32([np.float32(start - float(e)) for e in eps_end]),
        eps_end=f32(eps_end), gamma=f32(gamma),
        lr=f32(spec.lr) if spec.lr is not None else None)


def extract_member(tree, k: int):
    """Member k's slice of an [M]-stacked tree: every tensor leaf ``x`` of
    dicts, lists and tuples becomes ``x[k]``; other leaves stay."""
    if isinstance(tree, torch.Tensor):
        return tree[k]
    if isinstance(tree, dict):
        return {name: extract_member(v, k) for name, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(extract_member(v, k) for v in tree)
    return tree


def make_population_train(cfg: ExperimentConfig, env, net, device=None):
    """(init_population, run_population_chunk), the stacked twins of
    ``make_fused_train``'s (init, run_chunk).

    ``net`` is the stacked online net (``models.stack_networks`` of the M
    members' nets). ``init_population(seeds)`` builds the stacked carry
    from the members' seeds (``member_seeds``);
    ``run_population_chunk(carry, num_iters)`` advances all M members
    ``num_iters`` iterations, every metric an [M] tensor.
    """
    hp = member_hp(cfg, resolve_spec(cfg))
    # devtime: the caller registers the program (train.py _FusedTelemetry,
    # population.chunk).
    return make_fused_train(cfg, env, net, device=device, member_hp=hp)
