"""Plain PyTorch reference of one member's DQN grad step on the Nature CNN.

Written from the published descriptions, not from the program: the
Nature torso (Mnih et al. 2015), a scalar head, dueling as the port's
(Wang et al. 2016, with one hidden layer shared by both streams),
double-DQN bootstraps of n-step returns, prioritized replay's importance
weights (Schaul et al. 2016) and clip-by-global-norm then Adam (Kingma
and Ba 2015, epsilon outside the square root). It imports nothing of the
program or of JAX.

Layouts: observations are NHWC uint8 scaled by 1/255; conv weights are
[out, in, kh, kw]; the torso's output is flattened in (h, w, c) order;
dense weights are [out, in]. Parameter names are those of the benchmark's
weight files (``torso.convs.<i>``, ``hidden``, ``advantage``, ``value``).

``precision`` is "f32" (float32 with TF32 off: the reference), "bf16"
(each layer's input, weight, bias and output rounded to bfloat16, a
witness of the program's own precision) or "fp8" (the same rounding to
float8 e4m3: the control, one step below the configuration's bfloat16).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# (features, kernel, stride) of the Nature torso.
NATURE = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
PRECISIONS = {"f32": None, "bf16": torch.bfloat16,
              "fp8": torch.float8_e4m3fn}
FP8_MAX = 448.0
ADAM_B1, ADAM_B2 = 0.9, 0.999


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convolutions without TF32, restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def param_shapes(network: dict, num_actions: int, obs_shape
                 ) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """name -> (shape, fan_in) of every parameter, in forward order."""
    if int(network["num_atoms"]) > 1 or network["quantile"]:
        raise ValueError("the reference has the scalar head only")
    h, w, c = obs_shape
    out = {}
    c_in = c
    for i, (features, kernel, stride) in enumerate(NATURE):
        fan_in = c_in * kernel * kernel
        out[f"torso.convs.{i}.weight"] = ((features, c_in, kernel, kernel),
                                          fan_in)
        out[f"torso.convs.{i}.bias"] = ((features,), fan_in)
        h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
        c_in = features
    width, hidden = h * w * c_in, int(network["hidden"])
    out["hidden.weight"] = ((hidden, width), width)
    out["hidden.bias"] = ((hidden,), width)
    out["advantage.weight"] = ((num_actions, hidden), hidden)
    out["advantage.bias"] = ((num_actions,), hidden)
    if network["dueling"]:
        out["value.weight"] = ((1, hidden), hidden)
        out["value.bias"] = ((1,), hidden)
    return out


def _rounder(precision: str):
    """x -> x rounded to the precision's type and back to float32, with
    the gradient passed straight through."""
    dtype = PRECISIONS[precision]
    if dtype is None:
        return lambda x: x

    def rnd(x):
        y = x.clamp(-FP8_MAX, FP8_MAX) if precision == "fp8" else x
        return x + (y.to(dtype).float() - x).detach()

    return rnd


def forward(p: Dict[str, torch.Tensor], obs: torch.Tensor, network: dict,
            num_actions: int, precision: str = "f32") -> torch.Tensor:
    """Q-values [B, A] of one member's parameters ``p`` at uint8 NHWC
    ``obs`` [B, H, W, C]."""
    rnd = _rounder(precision)
    x = rnd(obs.float() / 255.0).permute(0, 3, 1, 2)
    for i, (_, _, stride) in enumerate(NATURE):
        x = rnd(F.relu(F.conv2d(x, rnd(p[f"torso.convs.{i}.weight"]),
                                rnd(p[f"torso.convs.{i}.bias"]),
                                stride=stride)))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = rnd(F.relu(F.linear(x, rnd(p["hidden.weight"]),
                            rnd(p["hidden.bias"]))))
    adv = rnd(F.linear(x, rnd(p["advantage.weight"]),
                       rnd(p["advantage.bias"])))
    if not network["dueling"]:
        return adv
    val = rnd(F.linear(x, rnd(p["value.weight"]), rnd(p["value.bias"])))
    return val + adv - adv.mean(dim=1, keepdim=True)


def huber(x: torch.Tensor, delta: float) -> torch.Tensor:
    a = x.abs()
    return torch.where(a <= delta, 0.5 * a * a, delta * (a - 0.5 * delta))


def n_step_returns(reward: torch.Tensor, terminated: torch.Tensor,
                   truncated: torch.Tensor, gamma: float):
    """Windows [S, n] -> (return, discount, k*): the discounted rewards up
    to and including the first step that ends the episode (or all n),
    the discount gamma^(k*+1) of the bootstrap, zero where that step
    ended the episode (truncation too: the ring keeps no pre-reset
    observation), and k*, the index of that last step."""
    S, n = reward.shape
    done = terminated | truncated
    ret = torch.zeros(S, dtype=torch.float32, device=reward.device)
    alive = torch.ones_like(ret)
    kstar = torch.full((S,), n - 1, dtype=torch.int64, device=reward.device)
    seen = torch.zeros(S, dtype=torch.bool, device=reward.device)
    for k in range(n):
        ret = ret + alive * (gamma ** k) * reward[:, k]
        kstar = torch.where(done[:, k] & ~seen, k, kstar)
        seen = seen | done[:, k]
        alive = alive * (~done[:, k]).float()
    rows = torch.arange(S, device=reward.device)
    ended = done[rows, kstar].float()
    discount = gamma ** (kstar + 1).double() * (1.0 - ended.double())
    return ret, discount.float(), kstar


def rebuild_stacks(frames: torch.Tensor, done: torch.Tensor,
                   at: torch.Tensor, stack: int) -> torch.Tensor:
    """The rolling frame stacks [S, H, W, stack] (oldest channel first) at
    window positions ``at`` [S], from single frames [S, L, H, W] and the
    done flags [S, L] of the same slots. Within an episode channel d
    (newest 0) is the frame d steps back; a stack that reaches past the
    episode's start repeats its first frame."""
    S = frames.shape[0]
    rows = torch.arange(S, device=frames.device)
    age = torch.full((S,), stack - 1, dtype=torch.int64,
                     device=frames.device)
    for j in range(stack - 1, 0, -1):       # the nearest episode end wins
        age = torch.where(done[rows, at - j], j - 1, age)
    chans = [frames[rows, at - torch.clamp(age, max=d)]
             for d in range(stack - 1, -1, -1)]
    return torch.stack(chans, dim=-1)


def transitions(window: Dict[str, torch.Tensor], n_step: int, gamma: float,
                stack: int, obs_shape) -> Dict[str, torch.Tensor]:
    """n-step transitions from raw ring windows: ``obs`` [S, L, row] uint8
    and ``reward``, ``terminated``, ``truncated`` [S, L] of slots t - c
    .. t + n (c = stack - 1 for single-frame storage, else 0) and
    ``action`` [S] at t."""
    c = stack - 1 if stack else 0
    reward = window["reward"][:, c:c + n_step].float()
    term = window["terminated"][:, c:c + n_step]
    trunc = window["truncated"][:, c:c + n_step]
    ret, discount, kstar = n_step_returns(reward, term, trunc, gamma)
    S, L = window["obs"].shape[:2]
    h, w, ch = obs_shape
    if stack:
        frames = window["obs"].reshape(S, L, h, w)
        done = window["terminated"] | window["truncated"]
        at = torch.full((S,), c, dtype=torch.int64, device=frames.device)
        obs = rebuild_stacks(frames, done, at, stack)
        next_obs = rebuild_stacks(frames, done, at + kstar + 1, stack)
    else:
        rows = window["obs"].reshape(S, L, h, w, ch)
        obs = rows[:, 0]
        next_obs = rows[torch.arange(S, device=rows.device), kstar + 1]
    return {"obs": obs, "action": window["action"].long(), "reward": ret,
            "discount": discount, "next_obs": next_obs}


def importance_weights(mass: torch.Tensor, total: float, n_valid: float,
                       beta: float) -> torch.Tensor:
    """(N P(i))^-beta over the batch's max, float64 -> float32; a pick of
    no mass weighs 0."""
    m = mass.double()
    w = (n_valid * m / total) ** (-beta)
    w = torch.where(m > 0, w, torch.zeros_like(w))
    return (w / w.max()).float()


def loss_and_priorities(p, tp, batch, weights, network, learner,
                        num_actions, precision="f32"):
    """(loss, priorities [S]) of one member's batch: the importance-weighted
    mean of the per-example Huber loss, and each example's |TD|."""
    fwd = lambda params, x: forward(params, x, network, num_actions,  # noqa: E731
                                    precision)
    delta = float(learner["huber_delta"])
    rows = torch.arange(batch["action"].shape[0], device=batch["action"].device)
    a = batch["action"]
    with torch.no_grad():
        next_target = fwd(tp, batch["next_obs"])
        if learner["double_dqn"]:
            select = fwd(p, batch["next_obs"])
        else:
            select = next_target
        best = select.argmax(dim=-1)
        target = batch["reward"] + batch["discount"] * next_target[rows,
                                                                   best]
    td = fwd(p, batch["obs"])[rows, a] - target
    return torch.mean(weights * huber(td, delta)), td.detach().abs()


def clip_adam(p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
              mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
              count: int, lr: float, learner: dict):
    """One clip-by-global-norm (scale by max/norm where norm >= max) then
    Adam update of one member; returns (params, mu, nu, clipped grads),
    new dicts."""
    max_norm = float(learner["max_grad_norm"])
    norm = math.sqrt(sum(float((x.double() ** 2).sum()) for x in g.values()))
    scale = max_norm / norm if max_norm and norm >= max_norm else 1.0
    g = {k: v * scale for k, v in g.items()}
    bc1 = 1.0 - ADAM_B1 ** count
    bc2 = 1.0 - ADAM_B2 ** count
    eps = float(learner["adam_eps"])
    mu = {k: (1 - ADAM_B1) * g[k] + ADAM_B1 * mu[k] for k in g}
    nu = {k: (1 - ADAM_B2) * g[k] * g[k] + ADAM_B2 * nu[k] for k in g}
    p = {k: p[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
         for k in g}
    return p, mu, nu, g


def linear_epsilon(iteration: int, start: float, end: float,
                   steps: int) -> float:
    """Exploration at ``iteration``: linear from ``start`` to ``end`` over
    ``steps`` iterations, then ``end``."""
    frac = 1.0 - min(max(iteration, 0), steps) / steps
    return (start - end) * frac + end


def beta_at(iteration: int, beta0: float, total_iters: int) -> float:
    """Importance exponent annealed linearly from beta0 to 1 over the
    configured run."""
    return beta0 + (1.0 - beta0) * min(iteration / total_iters, 1.0)
