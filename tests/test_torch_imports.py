"""The port stands alone: importing every module of dist_dqn_tpu_torch (and
chip_smoke.py) pulls in neither JAX nor anything of dist_dqn_tpu."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import dist_dqn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dist_dqn_tpu_torch.__path__,
                                               "dist_dqn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
r2d2 = {"dist_dqn_tpu_torch." + m for m in (
    "models.recurrent", "replay.sequence_device", "agents.r2d2",
    "r2d2_loop")}
assert r2d2 <= set(names), sorted(r2d2 - set(names))
slice4 = {"dist_dqn_tpu_torch.envs." + m for m in ("pixel_breakout",
                                                    "pixel_catch")}
assert slice4 <= set(names), sorted(slice4 - set(names))
slice5 = {"dist_dqn_tpu_torch.envs.pixel_reacher",
          "dist_dqn_tpu_torch.learning_bars"}
assert slice5 <= set(names), sorted(slice5 - set(names))
from dist_dqn_tpu_torch.models import ImplicitQuantileNetwork, NoisyDense
from dist_dqn_tpu_torch.ops.losses import (categorical_projection,
                                           iqn_quantile_huber_td,
                                           munchausen_bonus)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "dist_dqn_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 22 and bad.strip() == "[]"
