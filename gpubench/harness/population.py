"""The system under test: the port's population program, built as
``python -m dist_dqn_tpu_torch.train --config <preset> --population M``
builds it (``train.py _train_population``), driven chunk by chunk.

Set-up makes the members' weights on the device from the seed and fills
every member's ring to capacity, as a learner in its steady state holds
it: the program's own envs and actor write the newest slots, at the
iteration where a full ring puts them (exploration at its floor), and the
benchmark writes every older slot from the seed (``Population.fill``).
It then drives the first grad steps through the window's own call
(``run_chunk``) while it captures what the reference needs, and warms the
window's chunk up. The window then calls ``run_chunk(carry,
chunk_iters)`` until its seconds have passed.

What the capture holds (``Population.capture``), all on the host:

* ``weights``: {name: [M, ...]} float32, the benchmark's weights;
* ``plane_start``: [M, T, B] the priority plane the ring should hold
  before the first grad step: the running max (1) in the slots the envs
  wrote, the benchmark's priorities in the slots it wrote;
* ``steps``: per checked grad step, the program's priority plane
  ``plane_pre``/``plane_post`` [M, T, B] and running max
  ``max_pre``/``max_post`` [M] around the iteration that took it, the row
  ``pos`` that iteration added, the ring ``size`` at its draw, its
  ``iteration``, the members' ``loss`` [M], per member the ``cells``
  [S, 2] (t, b) it drew, pick by pick, and their importance ``weights``
  [M, S], and ``windows``: per member the raw ring slots t - c .. t + n of
  those cells (``obs`` rows [S, L, row] uint8, ``reward``, ``terminated``,
  ``truncated`` [S, L], ``action`` [S] at t);
* ``mu_first``: {name: [M, ...]} the Adam first moment after the first
  step; ``params_last``: the parameters after the last;
* ``act``: the envs' last ``act_check_iters`` iterations before
  training: ``iterations``, ``obs`` [M, L + c, B, row] and ``done`` of
  their slots (with c slots of stack context before), ``action``
  [M, L, B].
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, List, Optional

import torch

from gpubench.reference import dqn as ref_dqn


def experiment_config(experiment: dict, overrides: Optional[dict] = None):
    """The program's ExperimentConfig from a config file's ``experiment``
    object, with dotted ``overrides`` (tests' small sizes) applied."""
    from dist_dqn_tpu_torch.config import ExperimentConfig, apply_overrides

    fields = {}
    defaults = ExperimentConfig(name="", env_name="")
    for f in dataclasses.fields(ExperimentConfig):
        if f.name not in experiment:
            continue
        value = experiment[f.name]
        if isinstance(value, dict):
            cls = type(getattr(defaults, f.name))
            value = cls(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in value.items()})
        fields[f.name] = value
    cfg = ExperimentConfig(**fields)
    return apply_overrides(cfg, [f"{k}={v}" for k, v in
                                 (overrides or {}).items()])


def member_spec(cfg, traffic: dict) -> dict:
    """The ``--population-spec`` of the traffic's members: the Ape-X
    epsilon ladder eps_k = base^(1 + alpha k / (M - 1)), the config's
    learning rate times each member's scale, and the discounts where the
    traffic gives them."""
    M = traffic["members"]
    ladder = traffic["epsilon_ladder"]
    spec = {"epsilon": [ladder["base"] ** (1 + ladder["alpha"] * k
                                           / max(M - 1, 1))
                        for k in range(M)],
            "lr": [cfg.learner.learning_rate * s
                   for s in traffic["lr_scale"]]}
    if traffic.get("gamma"):
        spec["gamma"] = list(traffic["gamma"])
    return spec


def make_weights(shapes: Dict[str, tuple], members: int,
                 gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The members' float32 weights, drawn on ``gen``'s device in one
    call: N(0, 1/fan_in) for a weight, N(0, 0.01^2) for a bias."""
    device = gen.device
    sizes = [math.prod(shape) for shape, _ in shapes.values()]
    flat = torch.randn(members, sum(sizes), generator=gen, device=device)
    out = {}
    for (name, (shape, fan_in)), part in zip(
            shapes.items(), flat.split(sizes, dim=1)):
        scale = 0.01 if name.endswith("bias") else fan_in ** -0.5
        out[name] = (part * scale).reshape((members,) + tuple(shape))
    return out


# Ring slots whose frames are drawn at once: the draw's float32
# temporaries stay near 0.1 GB, under the window's own.
HISTORY_SLOTS = 256


class Population:
    """The program of one cell, set up and ready for its window."""

    def __init__(self, cell: dict, seed: int, device,
                 overrides: Optional[dict] = None,
                 traffic_overrides: Optional[dict] = None):
        from dist_dqn_tpu_torch import population as pop
        from dist_dqn_tpu_torch.config import PopulationConfig
        from dist_dqn_tpu_torch.envs import make_env
        from dist_dqn_tpu_torch.models import build_network, stack_networks

        config = cell["config"]
        traffic = dict(cell["traffic"], **(traffic_overrides or {}))
        self.traffic = traffic
        self.device = torch.device(device)
        base = experiment_config(config["experiment"], overrides)
        M = traffic["members"]
        self.spec = member_spec(base, traffic)
        cfg = dataclasses.replace(base, population=PopulationConfig(
            size=M, spec_json=json.dumps(self.spec)))
        self.cfg, self.members = cfg, M
        self.env_facts = config["env"]
        seeds = pop.member_seeds(seed, M)
        env = make_env(cfg.env_name, device=self.device)
        if (env.num_actions != self.env_facts["num_actions"]
                or list(env.observation_shape)
                != self.env_facts["observation_shape"]):
            raise ValueError(f"env {cfg.env_name}: {env.num_actions} "
                             f"actions, obs {env.observation_shape}; the "
                             f"config file says {self.env_facts}")
        self.num_actions = env.num_actions
        net = stack_networks([build_network(cfg.network, env.num_actions,
                                            env.observation_shape,
                                            device=self.device, seed=s)
                              for s in seeds])
        network = dataclasses.asdict(cfg.network)
        shapes = ref_dqn.param_shapes(network, env.num_actions,
                                      env.observation_shape)
        # Every input the benchmark makes (weights, the ring's history) is
        # drawn from this one generator, in this order.
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.weights = make_weights(shapes, M, self.gen)
        own = dict(net.named_parameters())
        if set(own) != set(self.weights):
            raise ValueError(f"the program's parameters {sorted(own)} are "
                             f"not the reference's {sorted(self.weights)}")
        with torch.no_grad():
            for name, value in self.weights.items():
                own[name].copy_(value)
        self.init, self.run_chunk = pop.make_population_train(
            cfg, env, net, device=self.device)
        self.carry = self.init(seeds)
        self.lanes = cfg.actor.num_envs
        self.stack = (env.frame_stack if cfg.replay.frame_dedup else 0)
        self.capture: Optional[dict] = None
        self.act: Optional[dict] = None
        self.plane_start: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def _chunk(self, iters: int):
        self.carry, metrics = self.run_chunk(self.carry, iters)
        return metrics

    def fill(self) -> int:
        """Fill every member's ring to capacity without a grad step; returns
        the iteration the program is at.

        The program's envs and actor run the last ``act_check_iters`` + c
        iterations before the ring is full (c: the stack's context), from
        the iteration where they fall in a run that filled the ring itself,
        so their exploration is at its floor; their slots are 0 .. E - 1.
        The benchmark writes the older slots E .. T - 1 from the seed
        (:meth:`_write_history`), and the ring counts T slots stored: the
        next add overwrites slot E, the oldest."""
        ring = self.carry.replay.ring
        T = ring.action.shape[-2]
        c = max(self.stack - 1, 0)
        E = self.traffic["act_check_iters"] + c
        n = self.cfg.learner.n_step
        if E * self.lanes >= self.cfg.replay.min_fill or T < E + n + c + 2:
            raise ValueError(
                f"{E} acting iterations of {self.lanes} lanes do not fit "
                f"under min_fill {self.cfg.replay.min_fill} and a ring of "
                f"{T} slots")
        self.carry.iteration = T - E
        chunk = self.traffic["chunk_iters"]
        while ring.pos < E:
            metrics = self._chunk(min(chunk, E - ring.pos))
            if metrics["grad_steps_in_chunk"]:
                raise RuntimeError("the program trained before its ring "
                                   "held min_fill transitions")
        self.act = self._act_capture(T - E, E)
        self._write_history(E)
        return self.carry.iteration

    def _write_history(self, start: int) -> None:
        """Slots ``start`` .. T - 1 of every member's ring, drawn from the
        seed in place: frames black but for the traffic's ``lit_share`` of
        pixels, at ``lit_value`` (PixelPong's ball and paddles light as
        many); actions uniform; rewards -1 or +1, each at half the
        traffic's ``reward_rate``, else 0; an episode's end at
        ``end_rate`` and at slot T - 1 (the envs' episodes start at slot
        0); priorities uniform on (0, 1], under the running max 1 that
        seeds the envs' slots."""
        r = self.carry.replay
        ring, gen, dev = r.ring, self.gen, self.device
        M, T, B = ring.action.shape
        rates = self.traffic["history"]
        obs, _ = self._fields()
        with torch.no_grad():
            for m in range(M):
                for part in obs[m, start:].split(HISTORY_SLOTS):
                    lit = torch.rand(part.shape, generator=gen, device=dev)
                    part.copy_(lit.lt_(rates["lit_share"]).to(torch.uint8)
                               .mul_(rates["lit_value"]))
            ring.action[:, start:].random_(0, self.num_actions,
                                           generator=gen)
            u = torch.rand((M, T - start, B), generator=gen, device=dev)
            half = rates["reward_rate"] / 2
            ring.reward[:, start:] = ((u < rates["reward_rate"]).float()
                                      - 2 * (u < half).float())
            ends = torch.rand((M, T - start, B), generator=gen,
                              device=dev) < rates["end_rate"]
            ends[:, -1] = True
            ring.terminated[:, start:] = ends
            ring.truncated[:, start:] = False
            plane = torch.ones((M, T, B), device=dev)
            plane[:, start:] = 1.0 - torch.rand((M, T - start, B),
                                                generator=gen, device=dev)
            r.priorities[:, start:] = plane[:, start:]
        ring.size = T
        self.plane_start = plane.cpu()

    def _plane(self):
        r = self.carry.replay
        return r.priorities.detach().cpu().clone(), \
            r.max_priority.detach().cpu().clone()

    def check_steps(self) -> None:
        """Drive the first ``check_grad_steps`` grad steps one iteration at
        a time through ``run_chunk`` and capture what the reference
        needs (the module's docstring). The draws are read where the
        fused loop takes them, ``replay/prioritized_device.py``
        ``prioritized_ring_sample``, for these steps only."""
        from dist_dqn_tpu_torch.replay import prioritized_device as pring

        M, n = self.members, self.cfg.learner.n_step
        c = max(self.stack - 1, 0)
        ring = self.carry.replay.ring
        T = ring.action.shape[-2]
        steps: List[dict] = []
        mu_first = None
        draws = []
        draw = pring.prioritized_ring_sample

        def recorded(*args, **kwargs):
            sample = draw(*args, **kwargs)
            draws.append([x.detach().cpu() for x in
                          (sample.t_idx, sample.b_idx, sample.weights)])
            return sample

        pring.prioritized_ring_sample = recorded
        try:
            while len(steps) < self.traffic["check_grad_steps"]:
                plane_pre, max_pre = self._plane()
                pos, iteration = ring.pos, self.carry.iteration
                draws.clear()
                metrics = self._chunk(1)
                if not metrics["grad_steps_in_chunk"]:
                    continue
                if len(draws) != 1:
                    raise RuntimeError(
                        f"a grad step made {len(draws)} draws through "
                        "prioritized_ring_sample; the check reads one")
                t_idx, b_idx, weights = draws[0]
                plane_post, max_post = self._plane()
                steps.append({
                    "iteration": iteration, "pos": pos, "size": ring.size,
                    "plane_pre": plane_pre, "max_pre": max_pre,
                    "plane_post": plane_post, "max_post": max_post,
                    "loss": metrics["loss"].detach().cpu(),
                    "cells": [torch.stack([t_idx[m], b_idx[m]], 1).long()
                              for m in range(M)],
                    "weights": weights})
                # Before the next add overwrites the oldest slots.
                steps[-1]["windows"] = [
                    self._windows(m, steps[-1]["cells"][m], c, n, T)
                    for m in range(M)]
                if mu_first is None:
                    names = [k for k, _ in
                             self.carry.learner.net.named_parameters()]
                    mu_first = {k: v.detach().cpu().clone() for k, v in
                                zip(names, self.carry.learner.opt_state.mu)}
        finally:
            pring.prioritized_ring_sample = draw
        params_last = {k: v.detach().cpu().clone() for k, v in
                       self.carry.learner.net.named_parameters()}
        cfg = self.cfg
        self.capture = {
            "members": M, "num_actions": self.num_actions,
            "obs_shape": tuple(self.env_facts["observation_shape"]),
            "stack": self.stack, "n_step": n,
            "network": dataclasses.asdict(cfg.network),
            "learner": dataclasses.asdict(cfg.learner),
            "replay": dataclasses.asdict(cfg.replay),
            "lr": list(self.spec["lr"]),
            "gamma": list(self.spec.get("gamma")
                          or [cfg.learner.gamma] * M),
            "eps_end": list(self.spec["epsilon"]),
            "eps_start": cfg.actor.epsilon_start,
            "eps_steps": max(cfg.actor.epsilon_decay_steps // self.lanes, 1),
            "total_iters": max(cfg.total_env_steps // self.lanes, 1),
            "weights": {k: v.cpu() for k, v in self.weights.items()},
            "plane_start": self.plane_start,
            "steps": steps, "mu_first": mu_first,
            "params_last": params_last, "act": self.act,
        }

    def _fields(self):
        ring = self.carry.replay.ring
        M, T, B = ring.action.shape
        return ring.obs.view(M, T, B, -1), ring

    def _windows(self, m: int, cells: torch.Tensor, c: int, n: int,
                 T: int) -> Dict[str, torch.Tensor]:
        obs, ring = self._fields()
        dev = obs.device
        t = cells[:, 0].to(dev)
        b = cells[:, 1].to(dev)[:, None]
        slots = (t[:, None] + torch.arange(-c, n + 1, device=dev)) % T
        return {"obs": obs[m, slots, b].cpu(),
                "reward": ring.reward[m, slots, b].cpu(),
                "terminated": ring.terminated[m, slots, b].cpu(),
                "truncated": ring.truncated[m, slots, b].cpu(),
                "action": ring.action[m, t, b[:, 0]].cpu()}

    def _act_capture(self, first: int, slots: int) -> dict:
        """The envs' slots 0 .. ``slots`` - 1, written from iteration
        ``first`` on: the last ``act_check_iters`` judged, the c before
        them their stacks' context."""
        obs, ring = self._fields()
        c = max(self.stack - 1, 0)
        return {"iterations": list(range(first + c, first + slots)),
                "obs": obs[:, :slots].cpu(),
                "done": (ring.terminated[:, :slots]
                         | ring.truncated[:, :slots]).cpu(),
                "action": ring.action[:, c:slots].cpu()}

    # ------------------------------------------------------------------
    def warm_up(self) -> None:
        """One chunk of the window's length: every shape the window uses."""
        metrics = self._chunk(self.traffic["chunk_iters"])
        metrics["loss"].tolist()

    def window(self, seconds: float) -> dict:
        """Chunks of ``chunk_iters`` until ``seconds`` have passed; each
        chunk's member losses are read (the one read a chunk of the train
        CLI makes). Returns the iterations, member env and grad steps,
        member grad steps that failed, and the wall seconds."""
        chunk, M, B = self.traffic["chunk_iters"], self.members, self.lanes
        iters = grad_steps = failed = 0
        error = None
        t0 = time.perf_counter()
        while True:
            try:
                metrics = self._chunk(chunk)
                losses = metrics["loss"].tolist()
            except RuntimeError as e:       # a CUDA fault or a shape error
                error = repr(e)
                lost = chunk // self.cfg.train_every * M
                grad_steps += lost
                failed += lost
                break
            g = metrics["grad_steps_in_chunk"]
            iters += chunk
            grad_steps += g * M
            if not all(math.isfinite(x) for x in losses):
                failed += g * M
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        return {"iterations": iters, "env_steps": iters * M * B,
                "grad_steps": grad_steps, "failed": failed, "wall_s": wall,
                "error": error}

    def free(self) -> None:
        """Drop the program's state (rings, nets, optimizer)."""
        self.carry = self.init = self.run_chunk = None
        self.weights = self.gen = None
