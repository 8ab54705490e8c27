"""Scaffolding of the fused training loops (twin of
dist_dqn_tpu/loop_common.py).

Config resolution (train batch, replay ratio, shard sizes, flat ring
storage, frame dedup), the bf16 actor snapshot, the loops' generators, the
epsilon / beta schedules (and a population's per-member epsilon), the
per-step episode trackers, the chunk metrics and the sampler routing. The
schedules are host functions of the host-int iteration counter, computed
in float32 as optax's ``linear_schedule`` computes them, so the loop never
reads the device to know them.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dist_dqn_tpu_torch.config import ExperimentConfig
from dist_dqn_tpu_torch.utils.pow2 import pad_pow2  # noqa: F401


def resolve_train_batch(cfg: ExperimentConfig) -> int:
    """Effective train-event batch width: ``learner.batch_size`` when
    ``replay.train_batch`` is 0, else that many rows rounded up to the next
    power of two."""
    if cfg.replay.train_batch <= 0:
        return cfg.learner.batch_size
    return pad_pow2(cfg.replay.train_batch)


def resolve_replay_ratio(cfg: ExperimentConfig) -> int:
    """Validated replay ratio (``replay.updates_per_chunk``): grad sub-steps
    per train event, >= 1."""
    r = cfg.replay.updates_per_chunk
    if r < 1:
        raise ValueError(f"replay.updates_per_chunk must be >= 1, got {r}")
    return r


def make_actor_param_cast(actor_dtype: str
                          ) -> Callable[[nn.Module], nn.Module]:
    """``snapshot(net)``, the net the actor reads for a chunk (the
    actor/learner dtype split).

    ``"float32"`` (the default) gives the identity: acting reads the live
    learner net. ``"bfloat16"`` gives a copy of ``net`` whose floating
    parameters are
    rounded to bf16; the loops take it once per chunk and act on it for
    the whole chunk, while the learner's f32 masters stay untouched. The
    copy is made on the first call and refreshed in place on later ones.
    Its layers compute in the net's own ``compute_dtype``, as flax promotes
    bf16 params against an f32 layer: the weights are rounded, the math of
    an f32 net stays f32. Every floating tensor of the copy is cast, so the
    nets hold no float buffers: the C51 support and IQN's frequencies are
    made in float32 at use, and a noisy layer forms its weight in float32
    from the rounded mu and sigma, as the JAX layer does from cast params.
    """
    if actor_dtype in ("", "float32"):
        return lambda net: net
    if actor_dtype != "bfloat16":
        raise ValueError(
            f"network.actor_dtype must be 'float32' or 'bfloat16', got "
            f"{actor_dtype!r}")
    held: Dict[str, Optional[nn.Module]] = {"copy": None, "source": None}

    @torch.no_grad()
    def snapshot(net: nn.Module) -> nn.Module:
        if held["source"] is not net:
            held["copy"] = copy.deepcopy(net).requires_grad_(False).to(
                torch.bfloat16)
            held["source"] = net
        else:
            for dst, src in zip(held["copy"].parameters(), net.parameters()):
                dst.copy_(src)
        return held["copy"]

    return snapshot


def shard_sizes(cfg: ExperimentConfig, num_shards: int = 1
                ) -> Tuple[int, int]:
    """Validate divisibility and return per-shard (num_envs, train_batch)."""
    train_batch = resolve_train_batch(cfg)
    for name, total in (("num_envs", cfg.actor.num_envs),
                        ("train_batch", train_batch)):
        if total % num_shards:
            raise ValueError(f"{name}={total} not divisible by "
                             f"num_shards={num_shards}")
    return cfg.actor.num_envs // num_shards, train_batch // num_shards


FLAT_AUTO_BYTES = 2 << 30


def resolve_flat_storage(rcfg, obs_shape, obs_dtype: torch.dtype,
                         num_slots: int, B: int,
                         store_final: bool = False,
                         prefer_flat: bool = False) -> bool:
    """Merged-row ("flat") obs storage for a device ring: the JAX package's
    rule, kept so both packages lay a config's ring out alike. Auto
    (``replay.flat_storage=None``): flat for multi-dim obs whose ring
    exceeds FLAT_AUTO_BYTES logical bytes, and always with ``prefer_flat``
    (frame-dedup rings, whose stored [H, W, 1] frames the JAX package
    never tiles)."""
    if rcfg.flat_storage is None:
        if prefer_flat and len(obs_shape) >= 2:
            return True
        obs_bytes = num_slots * B * torch.empty((), dtype=obs_dtype
                                                ).element_size()
        for d in obs_shape:
            obs_bytes *= d
        return (len(obs_shape) >= 2
                and obs_bytes * (2 if store_final else 1) > FLAT_AUTO_BYTES)
    return bool(rcfg.flat_storage) and len(obs_shape) >= 2


def flat_obs_codecs(flat_storage: bool, obs_shape):
    """(flatten_batched, unflatten_rows): [B, *obs_shape] -> [B, prod] at
    the insert boundary and [..., prod] -> [..., *obs_shape] after a
    gather; identities when the ring is not flat."""
    obs_shape = tuple(obs_shape)
    if not flat_storage:
        return (lambda x: x), (lambda x: x)
    return ((lambda x: x.reshape(x.shape[0], -1)),
            (lambda x: x.reshape(x.shape[:-1] + obs_shape)))


def resolve_frame_dedup(rcfg, env, obs_shape, store_final: bool = False):
    """Validate and resolve ``replay.frame_dedup`` for a fused loop.

    Returns (stack, stored_shape, frame_shape, slice_newest): the env's
    declared rolling-stack depth (0 = dedup off), the per-step obs shape as
    the ring stores it (one frame under dedup), the frame shape a
    merged-row gather reshapes to (None when off), and the insert-side
    slicer of [B, ...] obs."""
    obs_shape = tuple(obs_shape)
    declared = getattr(env, "frame_stack", 0)
    stack = declared if rcfg.frame_dedup else 0
    if rcfg.frame_dedup:
        if declared < 2:
            raise ValueError(
                "replay.frame_dedup=True but this env does not declare a "
                f"rolling frame stack (frame_stack is {declared}); dedup "
                "storage cannot rebuild its observations")
        if stack != obs_shape[-1]:
            raise ValueError(f"env.frame_stack={stack} does not match the "
                             f"obs last axis {obs_shape[-1]}")
        if store_final:
            raise ValueError(
                "replay.frame_dedup needs store_final_obs off (the final-obs "
                "buffer is not a rolling frame stream)")
    if not stack:
        return 0, obs_shape, None, (lambda obs: obs)
    stored_shape = obs_shape[:-1] + (1,)
    return stack, stored_shape, stored_shape, (lambda obs: obs[..., -1:])


def generators(seed: int, device: torch.device, n: int
               ) -> List[torch.Generator]:
    """``n`` device generators with independent seeds spawned from
    ``seed``."""
    seeds = np.random.SeedSequence(seed).generate_state(n, dtype=np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def rank_generators(seed: int, device: torch.device, rank: int = 0
                    ) -> List[torch.Generator]:
    """The fused loops' four generators (env, exploration, replay draws,
    learner) for rank ``rank`` of a mesh run, or for a single-device run
    (rank 0), where they are ``generators(seed, device, 4)``.

    The learner's is ``SeedSequence(seed)``'s fourth word on every rank:
    the replicated learner must draw the same IQN taus and layer noise
    everywhere (JAX keys it from the unfolded base key,
    ``train_loop.py:170-176``). The other three are per rank, as JAX folds
    the rank into the env, exploration and sample keys: rank 0 keeps the
    single-device run's first three words, so a world-size-1 mesh runs the
    single-device program, and rank r > 0 takes the first three words of
    ``SeedSequence(seed, spawn_key=(r,))``, a stream independent of the
    base one."""
    base = np.random.SeedSequence(seed).generate_state(4, dtype=np.uint64)
    own = (base if rank == 0 else np.random.SeedSequence(
        seed, spawn_key=(rank,)).generate_state(3, dtype=np.uint64))
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in (*own[:3], base[3])]


def _linear_schedule(init: float, end: float, steps: int
                     ) -> Callable[[int], float]:
    """optax.linear_schedule(init, end, steps)(count) in float32."""
    f32 = np.float32
    delta = f32(init - end)

    def at(count: int) -> float:
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(delta * frac + f32(end))

    return at


def make_schedules(cfg: ExperimentConfig, B: int, num_shards: int = 1
                   ) -> Tuple[Callable[[int], float], Callable[[int], float]]:
    """(epsilon(iteration), beta(iteration)): exploration decay and the PER
    importance exponent annealing beta0 -> 1 over the configured run, in
    iteration units, as host floats."""
    epsilon = _linear_schedule(
        cfg.actor.epsilon_start, cfg.actor.epsilon_end,
        max(cfg.actor.epsilon_decay_steps // (B * num_shards), 1))
    total_iters = max(cfg.total_env_steps // (B * num_shards), 1)
    f32 = np.float32
    beta0 = cfg.replay.importance_exponent

    def beta_at(iteration: int) -> float:
        frac = min(f32(iteration) / f32(total_iters), f32(1.0))
        return float(f32(beta0) + f32(1.0 - beta0) * frac)

    return epsilon, beta_at


def make_member_epsilon(cfg: ExperimentConfig, B: int, num_shards: int = 1
                        ) -> Callable:
    """A population's exploration decay: ``eps_at(iteration, delta, end)``
    with member vectors ``delta`` (epsilon_start - epsilon_end, folded on
    the host in float64 and cast to float32: population.member_hp) and
    ``end`` (float32 tensors or numpy arrays, [M]).

    The arithmetic of :func:`make_schedules`' epsilon with the constants
    as member lanes: the float32 ``1 - count / steps`` on the host, then
    ``delta * frac + end`` elementwise in float32, so member k's epsilon is
    bit for bit a solo run's with member k's epsilon_end."""
    steps = max(cfg.actor.epsilon_decay_steps // (B * num_shards), 1)
    f32 = np.float32

    def eps_at(iteration: int, delta, end):
        frac = f32(1) - f32(min(max(iteration, 0), steps)) / f32(steps)
        return delta * float(frac) + end

    return eps_at


def episode_stats_update(ep_return: torch.Tensor,
                         completed_return: torch.Tensor,
                         completed_count: torch.Tensor,
                         reward: torch.Tensor, done: torch.Tensor):
    """Fold one step's rewards/dones into the per-env episode trackers, on
    the device. Returns (ep_return, completed_return, completed_count); a
    population's [M, B] trackers fold into [M] sums."""
    ep_return = ep_return + reward
    zero = torch.zeros_like(ep_return)
    completed_return = completed_return + torch.where(done, ep_return,
                                                      zero).sum(dim=-1)
    completed_count = completed_count + done.float().sum(dim=-1)
    ep_return = torch.where(done, zero, ep_return)
    return ep_return, completed_return, completed_count


def chunk_metrics(carry, B: int, mesh=None) -> Dict[str, object]:
    """A chunk's metrics from a loop carry: device tensors the caller reads
    once per chunk ([M] for a population, per member), and host ints
    ``env_frames`` and ``grad_steps_in_chunk`` (per member).

    Under a ``mesh`` they are global, as JAX's ``reduce_chunk_metrics``
    makes them (``loop_common.py:280-305``): ``completed_return`` and
    ``completed_count`` summed over the ranks and ``loss_sum`` averaged,
    in one all-reduce; ``env_frames`` is ``iteration x B x size``. The
    grad-step count is a host int equal on every rank (every rank trains
    on the same iterations), so its mean is itself. The carry keeps the
    rank's own accumulators."""
    completed_return = carry.completed_return
    completed_count = carry.completed_count
    loss_sum = carry.loss_sum
    shards = 1
    if mesh is not None:
        shards = mesh.size
        completed_return, completed_count, loss_sum = mesh.psum(
            [completed_return, completed_count, loss_sum])
        loss_sum = loss_sum / shards
    return {
        "env_frames": carry.iteration * B * shards,
        "episode_return": completed_return / completed_count.clamp(min=1.0),
        "episodes": completed_count,
        "loss": loss_sum / max(carry.train_count, 1),
        "grad_steps_in_chunk": carry.train_count,
    }


def kernel_routing(enabled: bool, device: torch.device) -> bool:
    """Whether the priority draw goes through the sampler kernel's wrapper
    (``replay.pallas_sampler``). The wrapper then picks by the plane's
    device: the CUDA kernel on the card, its plain PyTorch version on the
    CPU, and nothing else — there is no fallback from one to the other."""
    if torch.device(device).type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return bool(enabled)
