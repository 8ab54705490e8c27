"""Pre-flight sizing gate for runs on the card (twin of
``dist_dqn_tpu/utils/sizing.py``: the same API and verdicts, the H100's
model and constants).

A job whose wall time exceeds the budget that will eventually kill it (an
external ``timeout``, a harness's time limit) is SIGTERM'd mid-run: the
work is lost, and a kill inside a device call holds the card until the
process is reaped. This module predicts the wall time of a fused-loop run from
per-iteration, per-env-step and per-grad-step costs measured on the card,
and its device memory from the port's ring storage, then refuses configs
whose prediction approaches the caller's kill budget or the card's memory
— plus the envelope rules:

* sizes **proven oversized** by a measured failure (``KNOWN_BAD``) are
  refused outright. The card has shown none yet, so the table is empty
  (JAX's 2048-lane v5e incident is that chip's, not this card's);
* sizes **more than 2x any proven-safe size** are refused as unproven.

Both refusals honor an explicit override (``BENCH_ALLOW_UNPROVEN=1``).

Calibration anchors: ``chip_smoke.py``'s main paths (NVIDIA H100 80GB
HBM3, power limit 700.00 W; the walls PERF.md §4–§6 records): apex's
28,000 frames (1,750 iterations of 16 lanes, 376 grad steps at batch 512)
in 15.6 s of ``train()`` wall, apex_dedup's 28,000 (752 grad steps) in
20.3 s, r2d2's 3,600 (69 grad steps of 64 x 125-step
windows, one in-run evaluation of 2,000 steps) in 23.2 s, atari on
PixelBreakout's 72,000 (64 lanes, 408 grad steps) in 11.6 s, rainbow's,
qrdqn's, iqn's and mdqn's 48,000 (110 grad steps) in 4.8–6.7 s. The
card's hosts ran 1.6 times apart in speed between calls (PERF.md §6), so
every constant charges at least 1.6 times the fastest measurement.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

# Time model (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's main-path
# walls). A fused iteration is launch-bound on the host: 4.6-5.3 ms
# of act + env step at 16-64 lanes before the fill (apex 3,281-3,500
# frames/s at 16 lanes, the 64-lane presets 12,117-15,401 at 64).
ITER_S = 0.008
# Per env step beyond the iteration: PixelReacher's renderer at 64 lanes
# is the dearest measured (12,117 frames/s); charged at 20 us a step.
ENV_STEP_S = 20e-6
# A feed-forward pixel grad step at batch 256-512: 14-15 ms (apex,
# apex_dedup) to 25 ms (rainbow's noisy C51) of chunk wall past the
# iteration's own.
GRAD_STEP_S = 0.045
# A vector-obs (MLP) grad step: 6.5 ms in the CartPole bar (10,938 grad
# steps in 79.5 s with their iterations).
GRAD_STEP_VECTOR_S = 0.015
# An R2D2 grad step (64 windows of 125 steps through the LSTM 512):
# 165 ms (6.06 grad steps/s).
GRAD_STEP_RECURRENT_S = 0.35
# One step of an in-run evaluation: r2d2's 2,000-step PixelPong
# evaluation took 8-18 s (4-9 ms a step).
EVAL_STEP_S = 0.015
# Set-up inside train(): the ring's allocation (28.2 GB for apex), the
# nets, the first chunk's cuDNN choices; plus the CLI's torch import and
# CUDA context (about 8 s per process on the card's machine).
COMPILE_BUDGET_S = 30.0
BUDGET_FRACTION = 0.6       # predicted time must fit in this fraction of the kill budget

# Envelope rules. "Proven safe" = the largest sizes chip_smoke.py has run
# clean on the card (NVIDIA H100 80GB HBM3, 700.00 W): 64 lanes (atari,
# rainbow, qrdqn, iqn, mdqn; the population's 4 x 16), batch 512 (apex),
# apex's 1M-slot PER ring (28.2 GB) and apex_dedup's 1M-slot dedup ring
# (7.06 GB). Dedup rings keep their own transition-count anchor: every
# slot-count-scaled cost (the priority plane, the sampler, the gather's
# index math) is unchanged by dedup; bytes are gated separately. Update
# when a larger size runs clean.
PROVEN_SAFE = {"num_envs": 64, "batch_size": 512, "ring": 1_000_000,
               "ring_dedup": 1_000_000}
# Measured failures on the card: none yet.
KNOWN_BAD: dict = {}

OVERRIDE_ENV = "BENCH_ALLOW_UNPROVEN"

# Memory model (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's peaks).
# The port's rings are preallocated tensors of the stored bytes (no
# layout padding, no second copy): apex's 1M-slot ring is
# 1,000,000 x 28,224 B = 28.2 GB, its peak 28.55 GB; apex_dedup's 7.06 GB,
# peak 7.33 GB; r2d2's 100,000 slots 2.8 GB, peak 5.55 GB (the unrolled
# LSTM's activations). The residue covers r2d2's 2.7 GB with margin.
H100_MEMORY_BYTES = 85_017_493_504   # bytes_limit of the 80 GB card
HBM_REFUSE_FRACTION = 0.9
PROGRAM_RESIDUE_BYTES = 4.0e9


def device_memory_bytes() -> float:
    """The card's memory (``torch.cuda.get_device_properties``), or the
    H100's where no card is visible (the CPU tests)."""
    import torch

    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return float(H100_MEMORY_BYTES)


def predict_fused_hbm_bytes(*, ring: int, pixel_obs: bool = True,
                            obs_elems: int = 84 * 84 * 4,
                            obs_itemsize: int = 1,
                            store_final_obs: bool = False,
                            flat_storage: Optional[bool] = None,
                            frame_dedup_stack: int = 0,
                            members: int = 1) -> float:
    """Conservative device-memory footprint of a fused-loop run.

    ``ring`` is the TOTAL capacity in transitions (the config knob, not
    per-lane slots); ``members`` rings for a population. A slot holds the
    observation's bytes (one frame with ``frame_dedup_stack`` > 0, the
    final observation beside it with ``store_final_obs``). ``flat_storage``
    is accepted for JAX's signature: the port's storage has no layout
    padding either way."""
    del flat_storage
    if not pixel_obs:
        return PROGRAM_RESIDUE_BYTES
    if frame_dedup_stack:
        obs_elems //= frame_dedup_stack
    logical = float(ring) * obs_elems * obs_itemsize
    if store_final_obs:
        logical *= 2
    return logical * max(members, 1) + PROGRAM_RESIDUE_BYTES


@dataclasses.dataclass(frozen=True)
class SizingVerdict:
    ok: bool
    predicted_s: float
    budget_s: float
    reason: str

    def as_fields(self) -> dict:
        return {"sizing_predicted_s": round(self.predicted_s, 1),
                "sizing_budget_s": round(self.budget_s, 1)}


def _override_active() -> bool:
    return os.environ.get(OVERRIDE_ENV) == "1"


def predict_fused_seconds(*, num_envs: int, batch_size: int,
                          train_every: int, chunk_iters: int,
                          num_chunks: int, num_evals: int = 0,
                          eval_iters: int = 0, pixel_obs: bool = True,
                          num_actions: int = 6,
                          compile_s: float = COMPILE_BUDGET_S,
                          min_fill: int = 0, updates_per_train: int = 1,
                          recurrent: bool = False) -> float:
    """Conservative wall-time prediction for a fused-loop run on the card.

    Terms: set-up + per-iteration host cost + env-step cost + grad steps
    (every ``train_every``-th iteration past the ``min_fill`` transitions,
    ``updates_per_train`` each) + evaluations. ``batch_size`` and
    ``num_actions`` are accepted for JAX's signature: the grad-step cost
    is the measured one of the card's presets, batch 64-512."""
    del batch_size, num_actions
    iters = float(num_chunks) * chunk_iters
    env_steps = iters * num_envs
    fill_iters = math.ceil(min_fill / max(num_envs, 1))
    grad_steps = (max(iters - fill_iters, 0.0) / max(train_every, 1)
                  * max(updates_per_train, 1))
    step_s = (GRAD_STEP_RECURRENT_S if recurrent
              else GRAD_STEP_S if pixel_obs else GRAD_STEP_VECTOR_S)
    return (compile_s
            + iters * ITER_S
            + env_steps * ENV_STEP_S
            + grad_steps * step_s
            + num_evals * eval_iters * EVAL_STEP_S)


def check_envelope(*, num_envs: int, batch_size: int,
                   ring: Optional[int] = None,
                   pixel_obs: bool = True,
                   frame_dedup_stack: int = 0) -> Optional[str]:
    """Hard size rules; None when inside the envelope, else the refusal
    reason. Override: BENCH_ALLOW_UNPROVEN=1.

    The envelope is the pixel (84x84x4) configs'; vector-obs runs are
    orders of magnitude smaller per lane/slot and rely on the time model
    alone."""
    if _override_active() or not pixel_obs:
        return None
    if "num_envs" in KNOWN_BAD and num_envs >= KNOWN_BAD["num_envs"]:
        return (f"num_envs={num_envs} is PROVEN OVERSIZED on this card "
                f"(>= {KNOWN_BAD['num_envs']} failed a measured run); set "
                f"{OVERRIDE_ENV}=1 to deliberately risk it")
    sized = {"num_envs": num_envs, "batch_size": batch_size}
    if ring is not None:
        # Transition COUNTS are what slot-scaled device costs follow, so
        # the bound stays in counts — dedup rings against their own
        # measured anchor, never the stacked bound divided by the stack.
        sized["ring_dedup" if frame_dedup_stack else "ring"] = ring
    for key, value in sized.items():
        if value > 2 * PROVEN_SAFE[key]:
            return (f"{key}={value} is more than 2x the proven-safe "
                    f"{PROVEN_SAFE[key]} (chip_smoke.py's largest clean "
                    f"run on the card); set {OVERRIDE_ENV}=1 to "
                    "deliberately risk it")
    return None


def gate_fused(*, budget_s: float, num_envs: int, batch_size: int,
               train_every: int, chunk_iters: int, num_chunks: int,
               ring: Optional[int] = None, num_evals: int = 0,
               eval_iters: int = 0, pixel_obs: bool = True,
               num_actions: int = 6,
               compile_s: float = COMPILE_BUDGET_S,
               frame_dedup_stack: int = 0, min_fill: int = 0,
               updates_per_train: int = 1, recurrent: bool = False,
               members: int = 1,
               store_final_obs: bool = False) -> SizingVerdict:
    """Combined envelope + memory + time-prediction gate for a fused run
    on the card.

    ``budget_s`` is whatever will kill the process (an external
    ``timeout``); the run must be predicted to finish in
    ``BUDGET_FRACTION`` of it or it is refused before any device work.
    """
    predicted = predict_fused_seconds(
        num_envs=num_envs * max(members, 1), batch_size=batch_size,
        train_every=train_every, chunk_iters=chunk_iters,
        num_chunks=num_chunks, num_evals=num_evals, eval_iters=eval_iters,
        pixel_obs=pixel_obs, num_actions=num_actions, compile_s=compile_s,
        min_fill=min_fill * max(members, 1),
        updates_per_train=updates_per_train * max(members, 1),
        recurrent=recurrent)
    envelope = check_envelope(num_envs=num_envs * max(members, 1),
                              batch_size=batch_size, ring=ring,
                              pixel_obs=pixel_obs,
                              frame_dedup_stack=frame_dedup_stack)
    if envelope is not None:
        return SizingVerdict(False, predicted, budget_s, envelope)
    if ring is not None and pixel_obs and not _override_active():
        hbm = predict_fused_hbm_bytes(ring=ring, pixel_obs=pixel_obs,
                                      frame_dedup_stack=frame_dedup_stack,
                                      members=members,
                                      store_final_obs=store_final_obs)
        capacity = device_memory_bytes()
        if hbm > HBM_REFUSE_FRACTION * capacity:
            return SizingVerdict(
                False, predicted, budget_s,
                f"predicted device memory {hbm / 1e9:.1f}G exceeds the "
                f"{HBM_REFUSE_FRACTION * capacity / 1e9:.1f}G gate (the "
                f"card has {capacity / 1e9:.2f}G): the ring is too large "
                "for the card — shrink replay.capacity "
                "(replay.frame_dedup stores one frame a slot); "
                f"{OVERRIDE_ENV}=1 to deliberately risk it")
    limit = BUDGET_FRACTION * budget_s
    if predicted > limit:
        return SizingVerdict(
            False, predicted, budget_s,
            f"predicted {predicted:.0f}s exceeds {BUDGET_FRACTION:.0%} of "
            f"the {budget_s:.0f}s kill budget — shrink the run or raise "
            "the budget; a run killed mid-chunk loses its work")
    return SizingVerdict(True, predicted, budget_s, "ok")


def fused_gate_args(cfg, env, total_env_steps: int,
                    chunk_iters: int) -> dict:
    """:func:`gate_fused`'s keywords (all but ``budget_s``) for a fused
    run of ``cfg`` on ``env`` (a port env: ``observation_shape``,
    ``num_actions``, ``max_steps``), as ``train()`` runs it: the CLI's
    gate and chip_smoke.py's check of the prediction against the wall
    use this one function."""
    lanes = cfg.actor.num_envs
    num_chunks = max(1, math.ceil(total_env_steps / (chunk_iters * lanes)))
    n_evals = (math.ceil(total_env_steps / cfg.eval_every_steps)
               if cfg.eval_every_steps else 0)
    pixel = len(env.observation_shape) == 3
    dedup = (getattr(env, "frame_stack", 0)
             if cfg.replay.frame_dedup and not cfg.network.lstm_size else 0)
    return dict(num_envs=lanes, batch_size=cfg.learner.batch_size,
                train_every=cfg.train_every, chunk_iters=chunk_iters,
                num_chunks=num_chunks, ring=cfg.replay.capacity,
                num_evals=n_evals,
                eval_iters=int(getattr(env, "max_steps", 0) or 0),
                pixel_obs=pixel, num_actions=env.num_actions,
                frame_dedup_stack=dedup, min_fill=cfg.replay.min_fill,
                updates_per_train=(max(cfg.updates_per_train, 1)
                                   * max(cfg.replay.updates_per_chunk, 1)),
                recurrent=bool(cfg.network.lstm_size),
                members=max(cfg.population.size, 1),
                store_final_obs=bool(cfg.replay.store_final_obs))
