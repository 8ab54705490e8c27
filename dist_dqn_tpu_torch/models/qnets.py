"""Feed-forward Q-networks: MLP / Nature-CNN torsos; scalar, dueling,
NoisyNet, C51 and QR-DQN heads; the IQN network.

Twin of ``dist_dqn_tpu/models/qnets.py``. Layouts follow the flax modules
so weights carry across (utils/params.py ``from_flax``) and outputs match:

  * the public input stays NHWC (``[B, 84, 84, 4]`` uint8, scaled by
    1/255 as at ``qnets.py:160-161``); convs run NCHW inside, and the conv
    output is permuted back to NHWC BEFORE the flatten, so the 3136-wide
    Dense sees flax's (h, w, c) order;
  * ``compute_dtype=torch.bfloat16`` casts each layer's input, weight and
    bias to bf16 and the head output back to f32, as flax does with f32
    params and ``dtype=bfloat16``;
  * a distributional head's ``A * M`` outputs are reshaped ``[B, A, M]``
    row-major, as flax's ``reshape((-1, A, M))``.

Randomness is injected, as the envs' draws are. A noisy net's forward
takes ``noise``: None (the mu-only map), a ``torch.Generator`` (each noisy
layer draws its factorised noise from it, one draw per layer per call,
shared by the whole batch) or a mapping from layer name to explicit raw
normals ``(eps_in, eps_out)``. IQN's tau draws are a generator or an
explicit ``[B, num]`` tensor. The C51 support and IQN's cosine
frequencies are computed in float32 at use, never held as buffers, so a
bf16 copy of the net (the bf16 actor) still uses float32 ones.

A population's M nets of one architecture train as one module
(:func:`stack_networks`): a copy of the solo module whose every parameter
holds the M members' values on a leading axis, under the solo names.
:func:`member_forward` runs a method of all M members at once through
``torch.func.vmap`` of ``functional_call``, which lowers the per-member
layers to batched matmuls and grouped convolutions; gradients flow to the
stacked parameters through ordinary autograd.

The recurrent R2D2 network is in ``models/recurrent.py``.
"""
from __future__ import annotations

import copy
import math
from typing import List, Mapping, Optional, Sequence, Tuple, Union

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


# What a noisy forward is given: nothing, a generator to draw from, or the
# raw normals (eps_in, eps_out) of each noisy layer by name.
Noise = Union[None, torch.Generator, Mapping[str, Tuple[torch.Tensor,
                                                        torch.Tensor]]]


def _signed_sqrt(e: torch.Tensor) -> torch.Tensor:
    return torch.sign(e) * torch.sqrt(e.abs())


class NoisyDense(nn.Module):
    """Factorised-Gaussian NoisyNet layer (Fortunato et al., 2018), twin of
    ``qnets.py:32-69``: w = mu_w + sigma_w * (f(eps_out) f(eps_in)^T), b =
    mu_b + sigma_b * f(eps_out), f(x) = sign(x) sqrt(|x|); mu ~ U(+-1 /
    sqrt(in)), sigma = sigma0 / sqrt(in). The noisy weight is formed in
    float32 (from whatever dtype the params hold), then cast with the input
    and bias to ``dtype``; the output is float32."""

    def __init__(self, in_features: int, out_features: int,
                 sigma0: float = 0.5, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.mu_w = nn.Parameter(torch.empty(out_features, in_features))
        self.mu_b = nn.Parameter(torch.empty(out_features))
        with torch.no_grad():
            self.mu_w.uniform_(-bound, bound, generator=generator)
            self.mu_b.uniform_(-bound, bound, generator=generator)
        self.sigma_w = nn.Parameter(torch.full((out_features, in_features),
                                               sigma0 * bound))
        self.sigma_b = nn.Parameter(torch.full((out_features,),
                                               sigma0 * bound))

    def draw(self, generator: torch.Generator
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One call's raw normals (eps_in [in], eps_out [out])."""
        out_f, in_f = self.mu_w.shape
        dev = self.mu_w.device
        return (torch.randn(in_f, generator=generator, device=dev),
                torch.randn(out_f, generator=generator, device=dev))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        w, b = self.mu_w, self.mu_b
        if eps is not None:
            eps_in, eps_out = (_signed_sqrt(e.float()) for e in eps)
            w = w + self.sigma_w * (eps_out[:, None] * eps_in[None, :])
            b = b + self.sigma_b * eps_out
        return F.linear(x.to(dtype), w.to(dtype), b.to(dtype)).float()


def _layer_noise(noise: Noise, name: str, layer: NoisyDense):
    if noise is None:
        return None
    if isinstance(noise, torch.Generator):
        return layer.draw(noise)
    return noise[name]


class QNetwork(nn.Module):
    """Configurable feed-forward Q-network (twin of ``qnets.py:117-194``).

    Output: [B, A] Q-values when ``num_atoms == 1``; otherwise [B, A,
    num_atoms], C51 logits over ``atoms()`` by default or quantile values
    with ``quantile``. ``q_values()`` reduces every head type to [B, A].
    """

    def __init__(self, num_actions: int, observation_shape: Tuple[int, ...],
                 torso: str = "nature",
                 mlp_features: Tuple[int, ...] = (256, 256),
                 hidden: int = 512, dueling: bool = False,
                 noisy: bool = False, num_atoms: int = 1,
                 v_min: float = -10.0, v_max: float = 10.0,
                 quantile: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_actions = num_actions
        self.num_atoms = num_atoms
        self.noisy = noisy
        self.quantile = quantile
        self.v_min, self.v_max = v_min, v_max
        self.compute_dtype = compute_dtype
        self.torso, width = make_torso(torso, observation_shape, mlp_features,
                                       compute_dtype, generator)
        self.hidden = _dense(width, hidden, generator) if hidden else None
        width = hidden or width

        def head(features):
            if noisy:
                return NoisyDense(width, features, generator=generator)
            return _dense(width, features, generator)

        self.advantage = head(num_actions * num_atoms)
        self.value = head(num_atoms) if dueling else None

    def atoms(self, device=None) -> torch.Tensor:
        """The C51 support, float32 (``jnp.linspace``'s values to an ulp)."""
        return torch.linspace(self.v_min, self.v_max, self.num_atoms,
                              dtype=torch.float32, device=device)

    def _head(self, name: str, x: torch.Tensor, noise: Noise
              ) -> torch.Tensor:
        layer = getattr(self, name)
        if self.noisy:
            return layer(x, self.compute_dtype,
                         _layer_noise(noise, name, layer))
        return _linear(layer, x, self.compute_dtype).float()

    def forward(self, obs: torch.Tensor, noise: Noise = None
                ) -> torch.Tensor:
        x = obs
        if x.dtype == torch.uint8:
            x = x.to(self.compute_dtype) / 255.0
        x = self.torso(x)
        if self.hidden is not None:
            x = F.relu(_linear(self.hidden, x, self.compute_dtype))
        adv = self._head("advantage", x, noise).reshape(
            -1, self.num_actions, self.num_atoms)
        if self.value is None:
            q = adv
        else:
            val = self._head("value", x, noise).reshape(-1, 1, self.num_atoms)
            q = val + adv - adv.mean(dim=1, keepdim=True)
        return q[..., 0] if self.num_atoms == 1 else q

    def q_values(self, obs: torch.Tensor, noise: Noise = None
                 ) -> torch.Tensor:
        """Scalar Q-values [B, A] for every head type (for acting)."""
        out = self(obs, noise)
        if self.num_atoms == 1:
            return out
        if self.quantile:
            return out.mean(dim=-1)
        return torch.sum(torch.softmax(out, dim=-1) * self.atoms(out.device),
                         dim=-1)


class ImplicitQuantileNetwork(nn.Module):
    """IQN (Dabney et al., 2018b), twin of ``qnets.py:197-314``: Z_tau(s, a)
    at quantile fractions tau, mixed into the state features through a
    cosine embedding (Hadamard product), with dueling over actions.

    ``forward(obs, taus=None)`` -> [B, A, K] at ``taus`` [B, K] (default:
    the acting fractions ``act_taus()``); ``sample_quantiles(obs, num,
    draw)`` -> ([B, A, num], taus [B, num]) at taus drawn U(0, 1) from the
    generator ``draw``, or at ``draw`` itself when it is a tensor;
    ``q_values(obs)`` -> [B, A], the mean over the acting fractions
    (CVaR_eta with ``risk_cvar_eta < 1``). No noisy heads: ``q_values``
    accepts ``noise`` and ignores it, so the actor calls every net alike.
    """

    iqn = True
    noisy = False

    def __init__(self, num_actions: int, observation_shape: Tuple[int, ...],
                 torso: str = "nature",
                 mlp_features: Tuple[int, ...] = (256, 256),
                 hidden: int = 512, dueling: bool = False,
                 embed_dim: int = 64, num_tau: int = 64,
                 num_tau_target: int = 64, num_tau_act: int = 32,
                 risk_cvar_eta: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_actions = num_actions
        self.embed_dim = embed_dim
        self.num_tau = num_tau
        self.num_tau_target = num_tau_target
        self.num_tau_act = num_tau_act
        self.risk_cvar_eta = risk_cvar_eta
        self.compute_dtype = compute_dtype
        self.torso, width = make_torso(torso, observation_shape, mlp_features,
                                       compute_dtype, generator)
        self.hidden = _dense(width, hidden, generator) if hidden else None
        width = hidden or width
        self.tau_embed = _dense(embed_dim, width, generator)
        self.advantage = _dense(width, num_actions, generator)
        self.value = _dense(width, 1, generator) if dueling else None

    def act_taus(self, device=None) -> torch.Tensor:
        """The num_tau_act midpoints of (0, risk_cvar_eta], float32."""
        k = self.num_tau_act
        mids = (torch.arange(k, dtype=torch.float32, device=device) + 0.5) / k
        return mids * self.risk_cvar_eta

    def forward(self, obs: torch.Tensor, taus: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        dtype = self.compute_dtype
        x = obs
        if x.dtype == torch.uint8:
            x = x.to(dtype) / 255.0
        x = self.torso(x)
        if self.hidden is not None:
            x = F.relu(_linear(self.hidden, x, dtype))
        if taus is None:
            taus = self.act_taus(x.device)[None, :].expand(
                x.shape[0], self.num_tau_act)
        freqs = torch.arange(self.embed_dim, dtype=torch.float32,
                             device=x.device)
        emb = torch.cos(math.pi * freqs[None, None, :]
                        * taus[..., None].float())             # [B, K, E]
        emb = F.relu(_linear(self.tau_embed, emb, dtype))      # [B, K, H]
        z = x[:, None, :] * emb
        adv = _linear(self.advantage, z, dtype).float()        # [B, K, A]
        if self.value is None:
            q = adv
        else:
            val = _linear(self.value, z, dtype).float()
            q = val + adv - adv.mean(dim=-1, keepdim=True)
        return q.transpose(1, 2)                               # [B, A, K]

    def sample_quantiles(self, obs: torch.Tensor, num: int,
                         draw: Union[torch.Generator, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """([B, A, num] values, [B, num] taus). One plain [B, num] block of
        U(0, 1) draws: the JAX package keys each example's taus by its
        batch position so a sharded batch draws the same ones, which a
        multi-card learner will need (ROADMAP.md)."""
        if isinstance(draw, torch.Generator):
            taus = torch.rand(obs.shape[0], num, generator=draw,
                              device=obs.device)
        else:
            taus = draw
        return self(obs, taus), taus

    def q_values(self, obs: torch.Tensor, noise: Noise = None
                 ) -> torch.Tensor:
        """[B, A] expected (eta = 1) or CVaR_eta action values."""
        return self(obs).mean(dim=-1)


def build_network(cfg: NetworkConfig, num_actions: int,
                  observation_shape: Tuple[int, ...], device=None,
                  seed: int = 0) -> nn.Module:
    """Build the Q-network for a config on ``device`` (default: the card),
    with weights drawn from ``seed``: the IQN network with ``cfg.iqn``,
    recurrent (models/recurrent.py) when ``cfg.lstm_size > 0``, else a
    :class:`QNetwork`. Raises the JAX package's ``ValueError``s for the
    head combinations it rejects (``qnets.py:320-343``)."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    gen = torch.Generator().manual_seed(seed)
    obs_shape = tuple(observation_shape)
    if cfg.iqn:
        if cfg.lstm_size or cfg.noisy or cfg.num_atoms > 1:
            raise ValueError(
                "the IQN head is feed-forward, epsilon-greedy and already "
                "distributional; unset lstm_size/noisy/num_atoms or iqn")
        if not 0.0 < cfg.risk_cvar_eta <= 1.0:
            raise ValueError(
                f"risk_cvar_eta must be in (0, 1], got "
                f"{cfg.risk_cvar_eta} — 1.0 is risk-neutral, smaller "
                "values average only the lower CVaR tail")
        net = ImplicitQuantileNetwork(
            num_actions, obs_shape, torso=cfg.torso,
            mlp_features=cfg.mlp_features, hidden=cfg.hidden,
            dueling=cfg.dueling, embed_dim=cfg.iqn_embed_dim,
            num_tau=cfg.iqn_tau_samples,
            num_tau_target=cfg.iqn_tau_target_samples,
            num_tau_act=cfg.iqn_tau_act, risk_cvar_eta=cfg.risk_cvar_eta,
            compute_dtype=dtype, generator=gen)
        return net.to(resolve_device(device))
    if cfg.lstm_size:
        if cfg.noisy or cfg.num_atoms > 1:
            raise ValueError(
                "noisy/distributional heads are not supported on the "
                "recurrent (R2D2) network; unset noisy/num_atoms or "
                "lstm_size")
        from dist_dqn_tpu_torch.models.recurrent import RecurrentQNetwork
        net = RecurrentQNetwork(
            num_actions, obs_shape, torso=cfg.torso,
            mlp_features=cfg.mlp_features, hidden=cfg.hidden,
            lstm_size=cfg.lstm_size, dueling=cfg.dueling,
            compute_dtype=dtype, remat_torso=cfg.remat_torso,
            lstm_dtype=(torch.bfloat16 if cfg.lstm_dtype == "bfloat16"
                        else torch.float32),
            lstm_unroll=cfg.lstm_unroll, generator=gen)
        return net.to(resolve_device(device))
    net = QNetwork(num_actions, obs_shape, torso=cfg.torso,
                   mlp_features=cfg.mlp_features, hidden=cfg.hidden,
                   dueling=cfg.dueling, noisy=cfg.noisy,
                   num_atoms=cfg.num_atoms, v_min=cfg.v_min,
                   v_max=cfg.v_max, quantile=cfg.quantile,
                   compute_dtype=dtype, generator=gen)
    return net.to(resolve_device(device))


# --------------------------------------------------------------------------
# A population's stacked nets.
# --------------------------------------------------------------------------

def stack_networks(nets: Sequence[nn.Module]) -> nn.Module:
    """One module for M nets of one architecture: a copy of ``nets[0]``
    whose parameters are ``torch.stack`` of the members' (leading axis M,
    solo names), with ``members`` = M set on it. Call it through
    :func:`member_forward`; a plain call raises on the shapes."""
    stacked = copy.deepcopy(nets[0])
    with torch.no_grad():
        for name, _ in nets[0].named_parameters():
            path, _, leaf = name.rpartition(".")
            values = [n.get_parameter(name).detach() for n in nets]
            setattr(stacked.get_submodule(path), leaf,
                    nn.Parameter(torch.stack(values)))
    stacked.members = len(nets)
    return stacked


def members_of(net: nn.Module) -> int:
    """M of a stacked net (:func:`stack_networks`); 0 for a solo net."""
    return getattr(net, "members", 0)


class _Method(nn.Module):
    """``forward(method, *args)`` calls ``net.method(*args)``, so
    ``functional_call`` reaches every method of a net, not only forward."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, method: str, *args):
        return getattr(self.net, method)(*args)


def call_with(net: nn.Module, params, method: str, *args):
    """``net.method(*args)`` with the parameters ``params`` (a name ->
    tensor dict) in place of the net's own, which may be stacked."""
    return torch.func.functional_call(
        _Method(net), {"net." + k: v for k, v in params.items()},
        (method,) + args)


class MemberView:
    """Member-level stand-in for a stacked net inside ``torch.func.vmap``:
    ``view(obs, noise)``, ``view.q_values(...)`` and
    ``view.sample_quantiles(...)`` run the solo net's methods on the
    member's slice of the parameters; any other attribute is the net's."""

    def __init__(self, net: nn.Module, params):
        self._net, self._params = net, params

    def __call__(self, *args):
        return call_with(self._net, self._params, "forward", *args)

    def q_values(self, *args):
        return call_with(self._net, self._params, "q_values", *args)

    def sample_quantiles(self, *args):
        return call_with(self._net, self._params, "sample_quantiles", *args)

    def __getattr__(self, name):
        return getattr(self._net, name)


def _in_dims(args) -> Tuple:
    return tuple(None if a is None or isinstance(a, (int, float, str))
                 else 0 for a in args)


def member_forward(net: nn.Module, method: str, *args):
    """``net.method(*args)`` for every member of a stacked net at once:
    tensor arguments carry the member axis first ([M, B, ...] obs; noise
    mappings and taus [M, ...]), as does the result; None and numbers are
    shared."""
    params = dict(net.named_parameters())

    def one(p, *a):
        return call_with(net, p, method, *a)

    return torch.func.vmap(one, in_dims=(0,) + _in_dims(args))(params,
                                                                 *args)


def noise_shapes(net: nn.Module) -> List[Tuple[str, int, int]]:
    """(name, in, out) of each noisy layer of a (solo or stacked) net, in
    the order one forward draws their noise."""
    return [(name, layer.mu_w.shape[-1], layer.mu_w.shape[-2])
            for name in ("advantage", "value")
            for layer in [getattr(net, name, None)]
            if isinstance(layer, NoisyDense)]


def draw_noise(net: nn.Module, generator: torch.Generator):
    """One forward's layer noise from ``generator``, as a solo forward
    given the generator draws it (``NoisyDense.draw`` per layer)."""
    dev = next(net.parameters()).device
    return {name: (torch.randn(n_in, generator=generator, device=dev),
                   torch.randn(n_out, generator=generator, device=dev))
            for name, n_in, n_out in noise_shapes(net)}
