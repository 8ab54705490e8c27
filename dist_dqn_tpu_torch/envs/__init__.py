"""Environment registry of the port: the batched on-device envs.

``dmc_pixels`` (the rainbow preset's env) is PixelReacher, as in the JAX
package's registry: the fused on-device loop runs the synthetic
DMC-shaped reacher.
"""
from __future__ import annotations

from typing import Optional

from dist_dqn_tpu_torch.envs.base import TorchEnv
from dist_dqn_tpu_torch.envs.cartpole import CartPole
from dist_dqn_tpu_torch.envs.pixel_breakout import PixelBreakout
from dist_dqn_tpu_torch.envs.pixel_catch import PixelCatch
from dist_dqn_tpu_torch.envs.pixel_pong import PixelPong
from dist_dqn_tpu_torch.envs.pixel_reacher import PixelReacher
from dist_dqn_tpu_torch.utils.device import resolve_device

__all__ = ["CartPole", "PixelBreakout", "PixelCatch", "PixelPong",
           "PixelReacher", "TorchEnv", "make_env"]

_ENVS = {"cartpole": CartPole, "pixel_pong": PixelPong,
         "pixel_breakout": PixelBreakout, "pixel_catch": PixelCatch,
         "dmc_pixels": PixelReacher}


def make_env(name: str, device: Optional[str] = None, **kwargs) -> TorchEnv:
    """Build a batched env by registry name, on ``device`` (default: the
    card; see utils/device.py)."""
    dev = resolve_device(device)
    if name not in _ENVS:
        raise KeyError(
            f"env {name!r} is not ported yet; the port has "
            f"{', '.join(sorted(_ENVS))}")
    return _ENVS[name](dev, **kwargs)
