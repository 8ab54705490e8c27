"""Carry flax Q-network weights across into the port's modules.

``from_flax(params_numpy, net)`` converts a flax param tree of the JAX
package's ``QNetwork`` (numpy leaves, e.g. ``jax.tree.map(np.asarray,
params)``) into a ``state_dict`` for the port's ``QNetwork`` — the way
every parity test shares weights between the two packages. Only numpy
crosses the boundary; this module imports no JAX.

  * conv kernels HWIO -> OIHW;
  * Dense kernels [in, out] -> [out, in];
  * ``CNNTorso_0/Conv_i`` -> ``torso.convs.i``, ``MLPTorso_0/Dense_i`` ->
    ``torso.layers.i``, top-level ``Dense_0`` -> ``hidden``, and the
    ``advantage`` / ``value`` heads and IQN's ``tau_embed`` keep their
    names;
  * NoisyNet heads (``NoisyDense``): ``mu_w`` / ``sigma_w`` [in, out] ->
    [out, in], ``mu_b`` / ``sigma_b`` as they are. A C51 / QR head's
    ``A * M`` outputs keep their order: flax reshapes them ``(-1, A, M)``
    row-major (output a * M + m), and so does the port;
  * the recurrent tree (``RecurrentQNetwork``): ``torso/CNNTorso_0`` or
    ``torso/MLPTorso_0`` -> ``torso.body``, ``torso/embed`` ->
    ``torso.embed``, and ``core/lstm``'s eight kernels (``ii`` .. ``io``
    without bias, ``hi`` .. ``ho`` with) stacked into ``core.weight_ih``,
    ``core.weight_hh`` and ``core.bias_hh`` in the port's (i, f, o, g)
    gate order.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _dense(prefix: str, leaf: Mapping, out: Dict[str, torch.Tensor]):
    if "mu_w" in leaf:                          # NoisyDense
        for name in ("mu_w", "sigma_w"):
            out[f"{prefix}.{name}"] = _tensor(np.asarray(leaf[name]).T)
        for name in ("mu_b", "sigma_b"):
            out[f"{prefix}.{name}"] = _tensor(leaf[name])
        return
    out[f"{prefix}.weight"] = _tensor(np.asarray(leaf["kernel"]).T)
    out[f"{prefix}.bias"] = _tensor(leaf["bias"])


def _torso(prefix: str, name: str, leaf: Mapping,
           out: Dict[str, torch.Tensor]) -> None:
    if name == "CNNTorso_0":
        for conv, sub in leaf.items():
            i = int(conv.split("_")[1])
            out[f"{prefix}.convs.{i}.weight"] = _tensor(
                np.transpose(np.asarray(sub["kernel"]), (3, 2, 0, 1)))
            out[f"{prefix}.convs.{i}.bias"] = _tensor(sub["bias"])
    elif name == "MLPTorso_0":
        for dense, sub in leaf.items():
            _dense(f"{prefix}.layers.{int(dense.split('_')[1])}", sub, out)
    else:
        raise KeyError(f"flax layer {name!r} is not a torso")


# The port's gate order (models/recurrent.py LSTMCore).
_GATES = ("i", "f", "o", "g")


def _lstm(prefix: str, leaf: Mapping, out: Dict[str, torch.Tensor]) -> None:
    """flax OptimizedLSTMCell params -> stacked [4H, E] / [4H, H] / [4H]."""
    names = {f"{kind}{gate}" for kind in "ih" for gate in _GATES}
    if set(leaf) != names or any(set(leaf[f"i{g}"]) != {"kernel"}
                                 for g in _GATES):
        raise KeyError(f"flax LSTM cell {sorted(leaf)} does not match "
                       "OptimizedLSTMCell's ii..io (no bias), hi..ho")

    def stack(kind, field):
        return np.concatenate([np.asarray(leaf[f"{kind}{g}"][field])
                               for g in _GATES], axis=-1)

    out[f"{prefix}.weight_ih"] = _tensor(stack("i", "kernel").T)
    out[f"{prefix}.weight_hh"] = _tensor(stack("h", "kernel").T)
    out[f"{prefix}.bias_hh"] = _tensor(stack("h", "bias"))


def from_flax(params: Mapping, net: torch.nn.Module
              ) -> Dict[str, torch.Tensor]:
    """State dict for ``net`` from the flax tree ``params`` (with or
    without the outer ``{"params": ...}`` collection). Raises KeyError on
    a tree that does not match ``net``'s layers."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if name in ("CNNTorso_0", "MLPTorso_0"):
            _torso("torso", name, leaf, out)
        elif name == "Dense_0":
            _dense("hidden", leaf, out)
        elif name in ("advantage", "value", "tau_embed"):
            _dense(name, leaf, out)
        elif name == "torso":                   # RecurrentQNetwork's embed
            for sub, sub_leaf in leaf.items():
                if sub == "embed":
                    _dense("torso.embed", sub_leaf, out)
                else:
                    _torso("torso.body", sub, sub_leaf, out)
        elif name == "core":
            _lstm("core", leaf["lstm"], out)
        else:
            raise KeyError(f"flax layer {name!r} has no counterpart in the "
                           "port's Q-networks")
    expected = set(net.state_dict())
    if set(out) != expected:
        raise KeyError(f"flax tree does not match the module: missing "
                       f"{sorted(expected - set(out))}, extra "
                       f"{sorted(set(out) - expected)}")
    return out
