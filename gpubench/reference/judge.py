"""The comparison that decides ``correct``: the plain reference follows the
program's first grad steps and every number it compares is read here.

Input is a capture the harness took from the timed path (its layout is
documented in ``gpubench/harness/population.py``): the benchmark's weights,
the program's priority planes around each checked grad step, the cells
each step drew and their importance weights, the raw ring slots of those
cells, the program's losses, its Adam first
moment after the first step and its parameters after the last, and the
actions of the last iterations before training.

The reference follows the program step by step from the program's own
replay state (the frames, actions and rewards in the ring, and the
priority plane each draw saw): it does not rerun the envs. The start of
that state and the stage that wrote it are checked by themselves: the
plane before the first step must be exactly the one the benchmark wrote
beside the envs' slots at the running max, and the envs' actions must be
greedy under the reference's Q-values as often as the exploration
schedule says.

Numbers (each with a limit of its own in ``gpubench/limits/<cell>.json``).
The learner's are taken per member, then the widest member, so that a
fault in one member's slice (its learning rate or discount, say) shows:

* ``loss_gap``: per member the median over the steps of the relative gap
  of its loss (the widest member-step swings with the one step whose
  bfloat16 loss rounds worst);
* ``grad_gap``: of the first step's clipped gradient, per leaf (a
  member's slice of a parameter) the gap of norms over the larger of the
  leaf's reference norm and the member's median leaf's, and of a
  member's leaves the median (the program's gradient read from its Adam
  first moment). The worst leaf is a conv bias whose gradient, a sum of
  many bfloat16 terms that cancel, swings from seed to seed by a factor
  of twenty in sound runs;
* ``update_gap``: the same of the parameters' change over the checked
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the member's median leaf's (Adam moves those by
  round-off);
* ``prio_gap``: of the priorities a step writes back, the norm of their
  difference from the reference's over the norm of the reference's,
  the widest over steps and members (one priority's gap swings with the
  rounding of a small |TD|);
* ``draw_gap``: the widest distance, in strata, from pick i's cell to
  stratum i (``per.judge_draw``);
* ``weight_gap``: the widest gap of an importance weight (they are at
  most 1);
* ``plane_gap``: cells and members that break the plane's rules: the
  plane the benchmark wrote, a new row at the running max, the running
  max itself;
* ``act_gap``: the widest gap, over the members, between the share of
  actions not greedy under the reference and the schedule's epsilon
  times (A - 1) / A.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from gpubench.reference import dqn, per

NUMBERS = ("loss_gap", "grad_gap", "update_gap", "prio_gap", "draw_gap",
           "weight_gap", "plane_gap", "act_gap")
# States whose best Q-value leads the second by less than this share of
# their largest |Q| are not judged: bfloat16 acting rounds Q-values by
# about 0.4 %.
GREEDY_TOL = 0.02
# Leaves whose reference gradient norm is under this share of the median
# leaf's are left out of update_gap.
STILL_LEAF = 1e-3


def prepare(cap: dict) -> dict:
    """The draws judged and the plane's rules checked: ``draw_gap``,
    ``plane_gap``, ``weight_gap`` and, per step and member, the picks'
    masses with the plane's total and valid count."""
    M, S = cap["members"], cap["learner"]["batch_size"]
    alpha = cap["replay"]["priority_exponent"]
    draw_gap = weight_gap = 0.0
    violations, steps = 0, []
    for k, st in enumerate(cap["steps"]):
        T = st["plane_pre"].shape[1]
        pos, size = st["pos"], st["size"]
        if k == 0:
            violations += int((st["plane_pre"] != cap["plane_start"]).sum())
        plane = st["plane_pre"].clone()
        plane[:, pos] = st["max_pre"][:, None]
        valid = per.valid_rows(T, (pos + 1) % T, size, cap["n_step"],
                               cap["stack"])
        beta = dqn.beta_at(st["iteration"],
                           cap["replay"]["importance_exponent"],
                           cap["total_iters"])
        members = []
        for m in range(M):
            violations += int((st["plane_post"][m, pos]
                               != st["max_pre"][m]).sum())
            cells = st["cells"][m]
            written = st["plane_post"][m][cells[:, 0], cells[:, 1]]
            want = torch.maximum(st["max_pre"][m], written.max())
            violations += int(st["max_post"][m] != want)
            judged = per.judge_draw(plane[m], valid, alpha, cells, S)
            judged["weights"] = dqn.importance_weights(
                judged["mass"], judged["total"], judged["n_valid"], beta)
            draw_gap = max(draw_gap, judged["gap"])
            if len(cells) == S:
                weight_gap = max(weight_gap, float(
                    (st["weights"][m] - judged["weights"]).abs().max()))
            else:
                weight_gap = float("inf")
            members.append(judged)
        steps.append(members)
    return {"draw_gap": draw_gap, "plane_gap": float(violations),
            "weight_gap": weight_gap, "steps": steps}


def _member(tree: Dict[str, torch.Tensor], m: int, device
            ) -> Dict[str, torch.Tensor]:
    return {k: v[m].to(device=device, dtype=torch.float32)
            for k, v in tree.items()}


def follow(cap: dict, prep: dict, precision: str = "f32",
           fault: Optional[str] = None, device="cpu") -> dict:
    """The reference in the program's place over the captured steps, in
    ``precision``: per step the members' losses and per-stratum
    priorities, the first step's clipped gradients and the parameters
    after the last step. ``fault`` "half" plants the half-batch fault:
    the loss is the mean over the first half of the rows, and only those
    rows' priorities are written; "member_lr" and "member_gamma" give
    member 0 the learning rate or the discount of the first member whose
    own differs."""
    M = cap["members"]
    net, learner = cap["network"], cap["learner"]
    A, n, stack = cap["num_actions"], cap["n_step"], cap["stack"]
    losses: List[List[float]] = []
    prios: List[List[torch.Tensor]] = []
    grad_first, params = {}, {}
    lr, gamma = list(cap["lr"]), list(cap["gamma"])
    for name, values in (("member_lr", lr), ("member_gamma", gamma)):
        if fault == name:
            values[0] = next(v for v in values if v != values[0])
    with dqn.exact_float32():
        for m in range(M):
            p = _member(cap["weights"], m, device)
            tp = {k: v.clone() for k, v in p.items()}
            mu = {k: torch.zeros_like(v) for k, v in p.items()}
            nu = {k: torch.zeros_like(v) for k, v in p.items()}
            for k, st in enumerate(cap["steps"]):
                window = {name: x.to(device)
                          for name, x in st["windows"][m].items()}
                batch = dqn.transitions(window, n, gamma[m], stack,
                                        cap["obs_shape"])
                w = prep["steps"][k][m]["weights"].to(device)
                if fault == "half":
                    half = len(w) // 2
                    batch = {name: x[:half] for name, x in batch.items()}
                    w = w[:half]
                leaves = {name: v.detach().requires_grad_(True)
                          for name, v in p.items()}
                loss, prio = dqn.loss_and_priorities(
                    leaves, tp, batch, w, net, learner, A, precision)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                p, mu, nu, g = dqn.clip_adam(
                    {k2: v.detach() for k2, v in leaves.items()},
                    dict(zip(leaves, grads)), mu, nu, k + 1, lr[m], learner)
                if (k + 1) % learner["target_update_period"] == 0:
                    tp = {k2: v.clone() for k2, v in p.items()}
                if k == 0:
                    grad_first[m] = {k2: v.cpu() for k2, v in g.items()}
                if len(losses) <= k:
                    losses.append([])
                    prios.append([])
                losses[k].append(float(loss.detach()))
                prios[k].append(prio.detach().cpu())
            params[m] = {k2: v.cpu() for k2, v in p.items()}
    return {"loss": losses, "prio": prios, "grad_first": grad_first,
            "params": params}


def _stack(per_member: Dict[int, Dict[str, torch.Tensor]]
           ) -> Dict[str, torch.Tensor]:
    names = per_member[0].keys()
    return {k: torch.stack([per_member[m][k] for m in sorted(per_member)])
            for k in names}


def _leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[tuple, float]:
    return {(k, m): float(v[m].double().norm()) for k, v in tree.items()
            for m in range(v.shape[0])}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: Optional[set] = None) -> Dict[tuple, float]:
    """Per leaf (a member's slice of a parameter; ``keep`` limits them),
    |norm(got) - norm(want)| over the larger of the leaf's reference norm
    and the member's median leaf's."""
    a, b = _leaf_norms(got), _leaf_norms(want)
    median = {m: statistics.median(v for (_, m2), v in b.items() if m2 == m)
              for _, m in b}
    return {key: abs(a[key] - b[key]) / max(b[key], median[key[1]], 1e-30)
            for key in b if keep is None or key in keep}


def widest_member(gaps: Dict[tuple, float],
                  detail: Optional[dict] = None) -> float:
    """Per member the median of its leaves' gaps, and of those the
    widest; ``detail``, where given, receives the members' medians and
    the worst leaf with its gap."""
    members = {}
    for (_, m), gap in gaps.items():
        members.setdefault(m, []).append(gap)
    medians = [statistics.median(members[m]) for m in sorted(members)]
    if detail is not None:
        worst = max(gaps, key=gaps.get)
        detail.update(members=medians, worst_leaf=f"{worst[0]}[{worst[1]}]",
                      worst_gap=gaps[worst])
    return max(medians)


def moving_leaves(grad: Dict[str, torch.Tensor]) -> set:
    """Leaves whose reference gradient norm reaches STILL_LEAF of their
    member's median leaf's."""
    norms = _leaf_norms(grad)
    median = {m: statistics.median(v for (_, m2), v in norms.items()
                                   if m2 == m) for _, m in norms}
    return {key for key, v in norms.items()
            if v >= STILL_LEAF * median[key[1]]}


def learner_numbers(cap: dict, ref: dict, got: dict) -> dict:
    """loss_gap, grad_gap, update_gap and prio_gap of ``got`` (the
    program's outputs, or a reference-in-place's) against ``ref``.
    ``got`` holds ``loss`` [steps][M], ``grad_first`` and ``params``
    ({name: [M, ...]}) and ``prio_written`` [steps][M] -> [S] tensors of
    the priority each stratum's cell holds after the step."""
    detail = got.setdefault("detail", {})
    loss = [statistics.median(abs(gs[m] - rs[m]) / max(abs(rs[m]), 1e-30)
                              for gs, rs in zip(got["loss"], ref["loss"]))
            for m in range(cap["members"])]
    detail["loss"] = {"members": loss}
    ref_grad = _stack(ref["grad_first"])
    grad_gap = widest_member(leaf_gaps(got["grad_first"], ref_grad),
                             detail.setdefault("grad", {}))
    start = cap["weights"]
    ref_delta = {k: v - start[k] for k, v in _stack(ref["params"]).items()}
    got_delta = {k: v.float() - start[k] for k, v in got["params"].items()}
    update_gap = widest_member(
        leaf_gaps(got_delta, ref_delta, moving_leaves(ref_grad)),
        detail.setdefault("update", {}))
    eps = cap["replay"]["priority_eps"]
    prio_gap = 0.0
    for gs, rs in zip(got["prio_written"], ref["prio"]):
        for g, r in zip(gs, rs):
            want = r.double() + eps
            prio_gap = max(prio_gap, float((g.double() - want).norm()
                                           / want.norm().clamp(min=1e-30)))
    return {"loss_gap": max(loss), "grad_gap": grad_gap,
            "update_gap": update_gap, "prio_gap": prio_gap}


def program_outputs(cap: dict) -> dict:
    """The program's outputs in ``learner_numbers``' layout."""
    b1 = dqn.ADAM_B1
    written = []
    for k, st in enumerate(cap["steps"]):
        row = []
        for m in range(cap["members"]):
            cells = st["cells"][m]
            row.append(st["plane_post"][m][cells[:, 0], cells[:, 1]])
        written.append(row)
    return {"loss": [list(map(float, st["loss"])) for st in cap["steps"]],
            "grad_first": {k: v.float() / (1 - b1)
                           for k, v in cap["mu_first"].items()},
            "params": cap["params_last"], "prio_written": written}


def in_place_outputs(cap: dict, out: dict) -> dict:
    """A reference-in-place's outputs in ``learner_numbers``' layout; a
    stratum whose row it did not write keeps the plane's old value."""
    eps = cap["replay"]["priority_eps"]
    written = []
    for k, st in enumerate(cap["steps"]):
        row = []
        for m in range(cap["members"]):
            cells = st["cells"][m]
            old = st["plane_pre"][m][cells[:, 0], cells[:, 1]].double()
            new = out["prio"][k][m].double() + eps
            row.append(torch.cat([new, old[len(new):]]))
        written.append(row)
    return {"loss": out["loss"], "grad_first": _stack(out["grad_first"]),
            "params": _stack(out["params"]), "prio_written": written}


def act_gap(cap: dict, device="cpu", alter: bool = False) -> float:
    """The widest gap over members between the share of captured actions
    not greedy under the reference's Q-values (at the benchmark's
    weights: no grad step precedes them) and the schedule's expected
    share, epsilon x (A - 1) / A. Only states whose best action leads the
    second by more than GREEDY_TOL of the largest |Q| are judged: there
    bfloat16 acting cannot pick another, and an explored action is the
    best one with probability 1 / A. ``alter`` plants an altered answer:
    every action moved to the next one."""
    act = cap["act"]
    A, stack = cap["num_actions"], cap["stack"]
    c = stack - 1 if stack else 0
    h, w, ch = cap["obs_shape"]
    iters = act["iterations"]
    worst = 0.0
    with dqn.exact_float32(), torch.no_grad():
        for m in range(cap["members"]):
            p = _member(cap["weights"], m, device)
            obs = act["obs"][m].to(device)          # [L + c, B, row]
            L, B = len(iters), obs.shape[1]
            if stack:
                frames = obs.reshape(L + c, B, h, w).transpose(0, 1)
                done = act["done"][m].to(device).transpose(0, 1)
                stacks = torch.cat([dqn.rebuild_stacks(
                    frames, done, torch.full((B,), c + i, device=device),
                    stack) for i in range(L)])
            else:
                stacks = obs.reshape(L, B, h, w, ch).reshape(L * B, h, w, ch)
            q = dqn.forward(p, stacks, cap["network"], A)
            actions = act["action"][m].to(device).reshape(-1).long()
            if alter:
                actions = (actions + 1) % A
            top = q.topk(2, dim=1).values
            judged = (top[:, 0] - top[:, 1]) > GREEDY_TOL * q.abs().max(
                dim=1).values
            eps = torch.tensor([dqn.linear_epsilon(
                t, cap["eps_start"], cap["eps_end"][m], cap["eps_steps"])
                for t in iters], dtype=torch.float64,
                device=device).repeat_interleave(B)
            explored = (actions != q.argmax(dim=1))[judged].double()
            expected = eps[judged] * (A - 1) / A
            if len(explored):
                worst = max(worst, abs(float(explored.mean()
                                             - expected.mean())))
    return worst


def readings(cap: dict, device="cpu", detail: Optional[dict] = None
             ) -> Dict[str, float]:
    """Every number compared, for the program's capture; ``detail``,
    where given, receives the members' loss, gradient and update gaps
    and the worst leaves of the last two."""
    prep = prepare(cap)
    ref = follow(cap, prep, "f32", device=device)
    got = program_outputs(cap)
    out = learner_numbers(cap, ref, got)
    if detail is not None:
        detail.update(got["detail"])
    out.update(draw_gap=prep["draw_gap"], plane_gap=prep["plane_gap"],
               weight_gap=prep["weight_gap"], act_gap=act_gap(cap, device))
    return {k: out[k] for k in NUMBERS}


def control_readings(cap: dict, device="cpu", detail: Optional[dict] = None
                     ) -> Dict[str, Dict[str, float]]:
    """The learner numbers of the reference in the program's place: in
    bfloat16 (a witness of the program's precision), in float8 (the
    control) and with the half-batch fault planted, each against the
    float32 reference; with member 0 given another member's learning rate
    or discount; the float32 reference's own outputs with every priority
    it writes doubled (an answer altered where it is produced); and
    act_gap with every action altered. ``detail``, where given, receives
    the bfloat16 witness's as ``readings`` gives the program's."""
    prep = prepare(cap)
    ref = follow(cap, prep, "f32", device=device)
    out = {}
    for name, precision, fault in (("bf16", "bf16", None),
                                   ("fp8", "fp8", None),
                                   ("half_batch", "f32", "half"),
                                   ("member_lr", "f32", "member_lr"),
                                   ("member_gamma", "f32", "member_gamma")):
        got = in_place_outputs(cap, follow(cap, prep, precision, fault,
                                           device=device))
        out[name] = learner_numbers(cap, ref, got)
        if detail is not None and name == "bf16":
            detail.update(got["detail"])
    doubled = dict(ref, prio=[[2 * x for x in row] for row in ref["prio"]])
    out["altered_priorities"] = learner_numbers(
        cap, ref, in_place_outputs(cap, doubled))
    out["altered_actions"] = {"act_gap": act_gap(cap, device, alter=True)}
    return out
