"""Is a seed's training run the same twice on the card?

    python -m dist_dqn_tpu_torch.utils.determinism_probe

Runs the iqn_cartpole learning bar's first 48,000 frames twice in one
process for each PER write-back (a plain ``index_put_``, whose order
among duplicate indices CUDA leaves undefined; the port's last-wins
election; the plain one under ``torch.use_deterministic_algorithms``),
recording per grad step the loss, the drawn indices and the priority
plane after the write-back, and prints for each the first grad step at
which the two runs differ, the evals, and how many duplicate draws wrote
different values. Then runs the r2d2 path (``replay.pallas_sampler=true``,
3,200 frames) twice and says whether params, priorities, ring and actor
carry are bit-equal. Then sums planes of 50,000, 200,000 and 1M floats
five times each with a flat ``torch.cumsum`` and with the PER cumsum
twin's scan of fixed order (``ops/sampler.fixed_order_cumsum``), and runs
the qrdqn path (a 200k PER ring drawn through that twin, 48,000 frames)
twice. Needs a CUDA card.

    python -m dist_dqn_tpu_torch.utils.determinism_probe --only cumsum

runs the last two only.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from dist_dqn_tpu_torch import learning_bars, train_loop
from dist_dqn_tpu_torch.config import CONFIGS, apply_overrides
from dist_dqn_tpu_torch.replay import prioritized_device as pring
from dist_dqn_tpu_torch.train import train


def index_put_update(state, t_idx, b_idx, new_priorities, eps=1e-6):
    """A PER write-back through ``index_put_``: where (t, b) appears twice,
    which value lands is up to the device."""
    p = new_priorities.abs() + eps
    state.priorities.index_put_((t_idx.long(), b_idx.long()), p)
    state.max_priority = torch.maximum(state.max_priority, p.max())
    return state


class Recorder:
    """Installs ``update`` as the loop's per-step write-back and records,
    per grad step, the loss, the sum of the drawn flat indices, the
    plane's sum after the write-back and the duplicate draws whose
    write-backs carry different values (device tensors, read at the
    end)."""

    def __init__(self, update):
        self.update = update
        self.loss, self.idx, self.plane, self.dup_diff = [], [], [], []

    def __enter__(self):
        real_make = train_loop.make_learner

        def make_learner(cfg, net, tx=None):
            init, step = real_make(cfg, net, tx)

            def recorded(state, batch, weights=None, draws=None):
                state, m = step(state, batch, weights, draws)
                self.loss.append(m["loss"].double())
                return state, m
            return init, recorded

        def update(state, t_idx, b_idx, prios, eps=1e-6):
            flat = t_idx.long() * state.priorities.shape[1] + b_idx.long()
            self.idx.append(flat.double().sum())
            srt, order = torch.sort(flat)
            pv = prios[order]
            self.dup_diff.append(((srt[1:] == srt[:-1])
                                  & (pv[1:] != pv[:-1])).sum())
            out = self.update(state, t_idx, b_idx, prios, eps=eps)
            self.plane.append(state.priorities.double().sum())
            return out

        self._saved = (real_make, pring.prioritized_ring_update)
        train_loop.make_learner = make_learner
        pring.prioritized_ring_update = update
        return self

    def __exit__(self, *exc):
        train_loop.make_learner, pring.prioritized_ring_update = self._saved

    def result(self) -> dict:
        return {k: torch.stack(getattr(self, k)).tolist()
                for k in ("loss", "idx", "plane", "dup_diff")}


def _first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _iqn_run(update, frames: int):
    cfg, _, chunk_iters = learning_bars.BARS["iqn_cartpole"][0]()
    with Recorder(update) as rec:
        carry, history = train(cfg, total_env_steps=frames,
                               chunk_iters=chunk_iters,
                               log_fn=lambda line: None, device="cuda")
    torch.cuda.synchronize()
    params = [p.detach().clone() for p in carry.learner.net.parameters()]
    return rec.result(), history, params


def compare_iqn(variant: str, update, deterministic: bool = False,
                frames: int = 48_000) -> dict:
    torch.use_deterministic_algorithms(deterministic)
    t0 = time.perf_counter()
    try:
        ra, ha, pa = _iqn_run(update, frames)
        rb, hb, pb = _iqn_run(update, frames)
    finally:
        torch.use_deterministic_algorithms(False)
    out = {"variant": variant, "seconds": time.perf_counter() - t0,
           "grad_steps": len(ra["loss"]),
           "evals_a": [r.get("eval_return") for r in ha],
           "evals_b": [r.get("eval_return") for r in hb],
           "chunk_loss_a": [r["loss"] for r in ha],
           "chunk_loss_b": [r["loss"] for r in hb],
           "params_equal": all(torch.equal(x, y) for x, y in zip(pa, pb)),
           "dup_writes_with_different_values_a": int(sum(ra["dup_diff"])),
           "grad_steps_with_such_dups_a": sum(1 for d in ra["dup_diff"]
                                              if d)}
    for k in ("loss", "idx", "plane"):
        out[f"first_step_diff_{k}"] = _first_diff(ra[k], rb[k])
    print(json.dumps({"iqn_twice": out}), flush=True)
    return out


def r2d2_twice(frames: int = 3_200) -> dict:
    cfg = apply_overrides(CONFIGS["r2d2"], ["replay.pallas_sampler=true"])
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        carry, history = train(cfg, total_env_steps=frames, chunk_iters=100,
                               log_fn=lambda line: None, device="cuda")
        torch.cuda.synchronize()
        runs.append((carry, history, time.perf_counter() - t0))
    (ca, ha, ta), (cb, hb, tb) = runs
    out = {"seconds": [ta, tb],
           "chunk_loss_a": [r["loss"] for r in ha],
           "chunk_loss_b": [r["loss"] for r in hb],
           "params_equal": all(torch.equal(x, y) for x, y in zip(
               ca.learner.net.parameters(), cb.learner.net.parameters())),
           "priorities_equal": torch.equal(ca.replay.priorities,
                                           cb.replay.priorities),
           "obs_equal": torch.equal(ca.replay.ring.obs, cb.replay.ring.obs),
           "carry_equal": all(torch.equal(x, y) for x, y in zip(
               ca.actor_carry, cb.actor_carry))}
    print(json.dumps({"r2d2_twice": out}), flush=True)
    return out


def cumsum_twice(sizes=(50_000, 200_000, 1_000_000), repeats: int = 5
                 ) -> dict:
    """A flat ``torch.cumsum`` of one plane ``repeats`` times, and the
    twin's fixed-order scan as often: whether every sum equals the first,
    the largest difference from it, and whether the plane lifted to
    [1, N] (the solo draw's route since the member axis) sums as the 1-D
    plane does."""
    from dist_dqn_tpu_torch.ops.sampler import fixed_order_cumsum

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n in sizes:
        x = torch.rand(n, generator=gen, device="cuda")
        x = x * (torch.rand(n, generator=gen, device="cuda") > 0.3)
        row = {}
        for name, scan in (("flat", lambda v: torch.cumsum(v, dim=-1)),
                           ("fixed_order", fixed_order_cumsum)):
            first = scan(x)
            again = [scan(x) for _ in range(repeats - 1)]
            row[name] = {
                "repeatable": all(torch.equal(first, y) for y in again),
                "max_abs_diff": max(float((first - y).abs().max())
                                    for y in again),
                "lifted_equals_1d": torch.equal(first, scan(x[None])[0])}
        out[str(n)] = row
    print(json.dumps({"cumsum_twice": out}), flush=True)
    return out


def cumsum_path_twice(frames: int = 48_000) -> dict:
    """The qrdqn preset's path twice: its PER draw goes through the cumsum
    twin (its fixed-order scan) over a 200k ring."""
    cfg = CONFIGS["qrdqn"]
    runs = []
    for _ in range(2):
        carry, history = train(cfg, total_env_steps=frames, chunk_iters=125,
                               log_fn=lambda line: None, device="cuda")
        torch.cuda.synchronize()
        runs.append((carry, history))
    (ca, ha), (cb, hb) = runs
    out = {"chunk_loss_a": [r["loss"] for r in ha],
           "chunk_loss_b": [r["loss"] for r in hb],
           "params_equal": all(torch.equal(x, y) for x, y in zip(
               ca.learner.net.parameters(), cb.learner.net.parameters())),
           "priorities_equal": torch.equal(ca.replay.priorities,
                                           cb.replay.priorities)}
    print(json.dumps({"qrdqn_twice": out}), flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=("all", "cumsum"), default="all",
                        help="cumsum: the cumsum checks only")
    args = parser.parse_args()
    # cuBLAS needs a fixed workspace for use_deterministic_algorithms.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        raise SystemExit("determinism_probe: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    if args.only == "all":
        compare_iqn("index_put", index_put_update)
        compare_iqn("last_wins", pring.prioritized_ring_update)
        compare_iqn("index_put_deterministic_algorithms", index_put_update,
                    deterministic=True)
        r2d2_twice()
    cumsum_twice()
    cumsum_path_twice()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
