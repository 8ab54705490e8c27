"""Feed-forward Q-networks: MLP / Nature-CNN torsos, scalar and dueling heads.

Twin of ``dist_dqn_tpu/models/qnets.py:75-195`` + ``build_network``
(``:317``). Layouts follow the flax modules so weights carry across
(utils/params.py ``from_flax``) and outputs match:

  * the public input stays NHWC (``[B, 84, 84, 4]`` uint8, scaled by
    1/255 as at ``qnets.py:160-161``); convs run NCHW inside, and the conv
    output is permuted back to NHWC BEFORE the flatten, so the 3136-wide
    Dense sees flax's (h, w, c) order;
  * ``compute_dtype=torch.bfloat16`` casts each layer's input, weight and
    bias to bf16 and the head output back to f32, as flax does with f32
    params and ``dtype=bfloat16``.

Noisy, distributional (C51/QR) and IQN heads are later slices of the
port; :func:`build_network` refuses them by name. The recurrent R2D2
network is in ``models/recurrent.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_dqn_tpu_torch.config import NetworkConfig
from dist_dqn_tpu_torch.utils.device import resolve_device

# (features, kernel, stride) stacks for the named CNN torsos:
#   nature — the 84x84 Atari torso (Mnih et al., 2015)
#   small  — ~7x cheaper variant for dev boxes and fast pixel tests
CNN_TORSO_LAYERS = {
    "nature": ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
    "small": ((16, 8, 4), (32, 4, 2)),
}

# flax's default kernel init, lecun_normal: a normal truncated at two
# standard deviations, rescaled so the truncated draw has variance
# 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


def _dense(in_f: int, out_f: int, generator) -> nn.Linear:
    layer = nn.Linear(in_f, out_f)
    _lecun_normal_(layer.weight, in_f, generator)
    nn.init.zeros_(layer.bias)
    return layer


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class CNNTorso(nn.Module):
    """Stacked VALID convs + flatten; ``layers`` holds one (features,
    kernel, stride) tuple per conv. Input NHWC, output [B, h*w*c] in
    flax's (h, w, c) flatten order."""

    def __init__(self, in_channels: int,
                 layers: Tuple[Tuple[int, int, int], ...] = CNN_TORSO_LAYERS[
                     "nature"],
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.strides = [s for _, _, s in layers]
        convs = []
        c_in = in_channels
        for features, kernel, _ in layers:
            conv = nn.Conv2d(c_in, features, kernel)
            _lecun_normal_(conv.weight, c_in * kernel * kernel, generator)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            c_in = features
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)          # NHWC -> NCHW
        for conv, stride in zip(self.convs, self.strides):
            x = F.relu(F.conv2d(x, conv.weight.to(self.dtype),
                                conv.bias.to(self.dtype), stride=stride))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def NatureCNN(in_channels: int = 4, dtype: torch.dtype = torch.float32,
              generator=None) -> CNNTorso:
    """The classic Atari torso as a CNNTorso preset."""
    return CNNTorso(in_channels, CNN_TORSO_LAYERS["nature"], dtype=dtype,
                    generator=generator)


class MLPTorso(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        layers = []
        for f in features:
            layers.append(_dense(in_features, f, generator))
            in_features = f
        self.layers = nn.ModuleList(layers)
        self.out_features = in_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for layer in self.layers:
            x = F.relu(_linear(layer, x, self.dtype))
        return x


def _conv_out(size: int, layers) -> int:
    for _, kernel, stride in layers:
        size = (size - kernel) // stride + 1
    return size


def make_torso(torso: str, observation_shape: Tuple[int, ...],
               mlp_features: Tuple[int, ...], dtype: torch.dtype,
               generator: Optional[torch.Generator]
               ) -> Tuple[nn.Module, int]:
    """The named torso for ``observation_shape`` and its output width."""
    if torso in CNN_TORSO_LAYERS:
        layers = CNN_TORSO_LAYERS[torso]
        h, w, c = observation_shape
        width = _conv_out(h, layers) * _conv_out(w, layers) * layers[-1][0]
        return CNNTorso(c, layers, dtype=dtype, generator=generator), width
    if torso == "mlp":
        body = MLPTorso(math.prod(observation_shape), mlp_features,
                        dtype=dtype, generator=generator)
        return body, body.out_features
    raise ValueError(f"unknown torso {torso!r}")


class QNetwork(nn.Module):
    """Configurable feed-forward Q-network with a scalar head: [B, A]
    Q-values, optionally through dueling value/advantage streams."""

    def __init__(self, num_actions: int, observation_shape: Tuple[int, ...],
                 torso: str = "nature",
                 mlp_features: Tuple[int, ...] = (256, 256),
                 hidden: int = 512, dueling: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_actions = num_actions
        self.compute_dtype = compute_dtype
        self.torso, width = make_torso(torso, observation_shape, mlp_features,
                                       compute_dtype, generator)
        self.hidden = _dense(width, hidden, generator) if hidden else None
        width = hidden or width
        self.advantage = _dense(width, num_actions, generator)
        self.value = _dense(width, 1, generator) if dueling else None

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        if x.dtype == torch.uint8:
            x = x.to(self.compute_dtype) / 255.0
        x = self.torso(x)
        if self.hidden is not None:
            x = F.relu(_linear(self.hidden, x, self.compute_dtype))
        adv = _linear(self.advantage, x, self.compute_dtype).float()
        if self.value is None:
            return adv
        val = _linear(self.value, x, self.compute_dtype).float()
        return val + adv - adv.mean(dim=1, keepdim=True)

    def q_values(self, obs: torch.Tensor) -> torch.Tensor:
        """Scalar Q-values [B, A] (for acting)."""
        return self(obs)


def build_network(cfg: NetworkConfig, num_actions: int,
                  observation_shape: Tuple[int, ...], device=None,
                  seed: int = 0) -> nn.Module:
    """Build the Q-network for a config on ``device`` (default: the card),
    with weights drawn from ``seed``: recurrent (models/recurrent.py) when
    ``cfg.lstm_size > 0``."""
    later = [name for name, on in (
        ("noisy", cfg.noisy), ("num_atoms>1", cfg.num_atoms > 1),
        ("iqn", cfg.iqn)) if on]
    if later:
        raise NotImplementedError(
            f"network {', '.join(later)} heads are not ported yet: they "
            "come with the distributional-heads slice (ROADMAP.md)")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    gen = torch.Generator().manual_seed(seed)
    if cfg.lstm_size:
        from dist_dqn_tpu_torch.models.recurrent import RecurrentQNetwork
        net = RecurrentQNetwork(
            num_actions, tuple(observation_shape), torso=cfg.torso,
            mlp_features=cfg.mlp_features, hidden=cfg.hidden,
            lstm_size=cfg.lstm_size, dueling=cfg.dueling,
            compute_dtype=dtype, remat_torso=cfg.remat_torso,
            lstm_dtype=(torch.bfloat16 if cfg.lstm_dtype == "bfloat16"
                        else torch.float32),
            lstm_unroll=cfg.lstm_unroll, generator=gen)
        return net.to(resolve_device(device))
    net = QNetwork(num_actions, tuple(observation_shape), torso=cfg.torso,
                   mlp_features=cfg.mlp_features, hidden=cfg.hidden,
                   dueling=cfg.dueling, compute_dtype=dtype, generator=gen)
    return net.to(resolve_device(device))
