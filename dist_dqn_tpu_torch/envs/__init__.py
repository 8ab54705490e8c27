"""Environment registry of the port: the batched on-device envs."""
from __future__ import annotations

from typing import Optional

from dist_dqn_tpu_torch.envs.base import TorchEnv
from dist_dqn_tpu_torch.envs.cartpole import CartPole
from dist_dqn_tpu_torch.envs.pixel_pong import PixelPong
from dist_dqn_tpu_torch.utils.device import resolve_device

__all__ = ["CartPole", "PixelPong", "TorchEnv", "make_env"]


def make_env(name: str, device: Optional[str] = None, **kwargs) -> TorchEnv:
    """Build a batched env by registry name, on ``device`` (default: the
    card; see utils/device.py)."""
    dev = resolve_device(device)
    if name == "cartpole":
        return CartPole(dev, **kwargs)
    if name == "pixel_pong":
        return PixelPong(dev, **kwargs)
    raise KeyError(
        f"env {name!r} is not ported yet; the port has cartpole and "
        "pixel_pong")
