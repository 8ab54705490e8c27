"""Environment registry of the port: the batched on-device envs.

``dmc_pixels`` (the rainbow preset's env) is PixelReacher, as in the JAX
package's registry: the fused on-device loop runs the synthetic
DMC-shaped reacher. The host envs the Ape-X actors step
(``gym_adapter.py``, ``host_pong.py``, ``host_breakout.py``) are numpy
only; so that an actor process can import them without torch, the batched
envs load lazily, on first access.
"""
from __future__ import annotations

import importlib
from typing import Optional

__all__ = ["CartPole", "PixelBreakout", "PixelCatch", "PixelPong",
           "PixelReacher", "TorchEnv", "make_env"]

_LAZY = {"TorchEnv": "base", "CartPole": "cartpole",
         "PixelBreakout": "pixel_breakout", "PixelCatch": "pixel_catch",
         "PixelPong": "pixel_pong", "PixelReacher": "pixel_reacher"}

_ENVS = {"cartpole": "CartPole", "pixel_pong": "PixelPong",
         "pixel_breakout": "PixelBreakout", "pixel_catch": "PixelCatch",
         "dmc_pixels": "PixelReacher"}


def __getattr__(name: str):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_env(name: str, device: Optional[str] = None, **kwargs):
    """Build a batched env by registry name, on ``device`` (default: the
    card; see utils/device.py)."""
    from dist_dqn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if name not in _ENVS:
        raise KeyError(
            f"env {name!r} is not ported yet; the port has "
            f"{', '.join(sorted(_ENVS))}")
    return __getattr__(_ENVS[name])(dev, **kwargs)
