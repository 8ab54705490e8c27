"""Recurrent (R2D2) Q-network: torso -> LSTM core -> dueling head.

Twin of ``dist_dqn_tpu/models/recurrent.py:30-170``, laid out so flax
weights carry across (utils/params.py ``from_flax``) and outputs match:

  * the embed (torso + ``embed`` Dense) runs in ``compute_dtype`` and
    returns float32; the torso runs ONCE over the flattened [T*B] frames of
    an unroll, never per time step;
  * the core is flax's ``OptimizedLSTMCell`` written out as two matmuls and
    pointwise ops: input kernels without bias, hidden kernels with bias, a
    (c, h) carry. With ``lstm_dtype=bfloat16`` x, h, the kernels and the
    bias are cast to bf16; ``h W_h + b`` and ``x W_i`` are computed and
    added in bf16 and the gate nonlinearities run in bf16, while
    ``f * c`` promotes to float32 against the float32 carry and
    ``h = o * tanh(c)`` is float32, as in flax. ``nn.LSTMCell`` and cuDNN's
    ``nn.LSTM`` have other dtype rules and two biases, and cannot zero the
    carry at reset flags in the middle of a sequence;
  * the ``advantage`` / ``value`` heads run in float32.

The port stores the four gate blocks in (i, f, o, g) order, so one sigmoid
covers the first three and one tanh the last; ``from_flax`` reorders
flax's (i, f, g, o).

``lstm_unroll`` is accepted and changes nothing: in the JAX package it is
the ``lax.scan`` unroll factor, pure scheduling with the math unchanged
(pinned by ``tests/test_recurrent_knobs.py``). Here the time loop is a
Python loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dist_dqn_tpu_torch.models.qnets import _dense, _lecun_normal_, \
    _linear, make_torso

LSTMCarry = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each [B, lstm] f32


class _Embed(nn.Module):
    """Torso + pre-LSTM dense: [N, ...obs] -> [N, E] float32."""

    def __init__(self, observation_shape: Tuple[int, ...], torso: str,
                 mlp_features: Tuple[int, ...], hidden: int,
                 dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.dtype = dtype
        self.body, width = make_torso(torso, observation_shape, mlp_features,
                                      dtype, generator)
        self.embed = _dense(width, hidden, generator) if hidden else None
        self.out_features = hidden or width

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        if x.dtype == torch.uint8:
            x = x.to(self.dtype) / 255.0
        x = self.body(x)
        if self.embed is not None:
            x = F.relu(_linear(self.embed, x, self.dtype))
        return x.float()


class LSTMCore(nn.Module):
    """flax's ``OptimizedLSTMCell`` (lecun-normal input kernels, orthogonal
    hidden kernels, zero bias), gate blocks stacked in (i, f, o, g)
    order."""

    def __init__(self, in_features: int, lstm_size: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H = lstm_size
        self.lstm_size = H
        self.dtype = dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * H, in_features))
        self.weight_hh = nn.Parameter(torch.empty(4 * H, H))
        self.bias_hh = nn.Parameter(torch.zeros(4 * H))
        with torch.no_grad():
            for k in range(4):
                _lecun_normal_(self.weight_ih[k * H:(k + 1) * H], in_features,
                               generator)
                nn.init.orthogonal_(self.weight_hh[k * H:(k + 1) * H],
                                    generator=generator)

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """``x W_i`` for all rows at once: [N, E] -> [N, 4H] in the cell's
        dtype (the same product per row as flax's per-step one)."""
        return F.linear(x.to(self.dtype), self.weight_ih.to(self.dtype))

    def step(self, carry: LSTMCarry, x_gates: torch.Tensor,
             w_hh: torch.Tensor, b_hh: torch.Tensor) -> LSTMCarry:
        """One cell step from the input gates ``x_gates`` [B, 4H]; ``w_hh``
        and ``b_hh`` are the hidden kernel and bias already cast to the
        cell's dtype (once per unroll, not per step)."""
        c, h = carry
        H = self.lstm_size
        gates = F.linear(h.to(self.dtype), w_hh) + b_hh
        gates = gates + x_gates
        i, f, o = torch.sigmoid(gates[:, :3 * H]).chunk(3, dim=1)
        g = torch.tanh(gates[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        return c.float(), h.float()


class RecurrentQNetwork(nn.Module):
    """LSTM Q-network with an optional dueling head (R2D2).

    ``net.unroll(carry, obs [T, B, ...], reset [T, B])`` and the one-step
    ``net(carry, obs [B, ...], reset [B])`` (a length-1 unroll) share one
    parameter set; both return ``(new_carry, q)`` with q float32.
    """

    def __init__(self, num_actions: int, observation_shape: Tuple[int, ...],
                 torso: str = "nature",
                 mlp_features: Tuple[int, ...] = (256, 256),
                 hidden: int = 512, lstm_size: int = 512,
                 dueling: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 remat_torso: bool = False,
                 lstm_dtype: torch.dtype = torch.float32,
                 lstm_unroll: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_actions = num_actions
        self.lstm_size = lstm_size
        self.compute_dtype = compute_dtype
        # Recompute the embed's activations in the backward pass (memory
        # for FLOPs), with the same parameters.
        self.remat_torso = remat_torso
        self.lstm_unroll = lstm_unroll    # scheduling only: see the module
        self.torso = _Embed(tuple(observation_shape), torso, mlp_features,
                            hidden, compute_dtype, generator)
        self.core = LSTMCore(self.torso.out_features, lstm_size,
                             dtype=lstm_dtype, generator=generator)
        self.advantage = _dense(lstm_size, num_actions, generator)
        self.value = _dense(lstm_size, 1, generator) if dueling else None

    def initial_state(self, batch_size: int) -> LSTMCarry:
        """A zero (c, h) carry on the parameters' device."""
        dev = self.advantage.weight.device
        shape = (batch_size, self.lstm_size)
        return (torch.zeros(shape, dtype=torch.float32, device=dev),
                torch.zeros(shape, dtype=torch.float32, device=dev))

    def _embed(self, obs: torch.Tensor) -> torch.Tensor:
        if self.remat_torso and torch.is_grad_enabled():
            return checkpoint(self.torso, obs, use_reentrant=False)
        return self.torso(obs)

    def _q_head(self, h: torch.Tensor) -> torch.Tensor:
        """[N, H] -> [N, A] float32, dueling-combined when configured."""
        adv = F.linear(h, self.advantage.weight, self.advantage.bias)
        if self.value is None:
            return adv
        val = F.linear(h, self.value.weight, self.value.bias)
        return val + adv - adv.mean(dim=-1, keepdim=True)

    def forward(self, carry: LSTMCarry, obs: torch.Tensor,
                reset: Optional[torch.Tensor] = None
                ) -> Tuple[LSTMCarry, torch.Tensor]:
        """One step: obs [B, ...], reset [B] bool (None: no resets)."""
        carry, q = self.unroll(carry, obs[None],
                               None if reset is None else reset[None])
        return carry, q[0]

    def unroll(self, carry: LSTMCarry, obs: torch.Tensor,
               reset: Optional[torch.Tensor] = None
               ) -> Tuple[LSTMCarry, torch.Tensor]:
        """obs [T, B, ...], reset [T, B] bool; returns q [T, B, A].

        ``reset[t]`` zeroes the carry before step t (obs[t] opens a new
        episode), so an unroll across an episode boundary recomputes the
        hidden states the actor saw.
        """
        T, B = obs.shape[:2]
        x = self._embed(obs.reshape((T * B,) + tuple(obs.shape[2:])))
        x_gates = self.core.input_gates(x).reshape(T, B, -1)
        w_hh = self.core.weight_hh.to(self.core.dtype)
        b_hh = self.core.bias_hh.to(self.core.dtype)
        keep = None if reset is None else (~reset).float()[..., None]
        hs = []
        for t in range(T):
            if keep is not None:
                carry = (carry[0] * keep[t], carry[1] * keep[t])
            carry = self.core.step(carry, x_gates[t], w_hh, b_hh)
            hs.append(carry[1])
        q = self._q_head(torch.stack(hs).reshape(T * B, -1))
        return carry, q.reshape(T, B, self.num_actions)
