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
slice6 = {"dist_dqn_tpu_torch.utils.checkpoint", "dist_dqn_tpu_torch.evaluate"}
assert slice6 <= set(names), sorted(slice6 - set(names))
assert "dist_dqn_tpu_torch.population" in names
slice8 = {"dist_dqn_tpu_torch." + m for m in (
    "host_replay_loop", "replay.host", "replay.host_ring", "replay.staging",
    "utils.ckpt_schema")}
assert slice8 <= set(names), sorted(slice8 - set(names))
slice9 = {"dist_dqn_tpu_torch." + m for m in (
    "actors", "actors.service", "actors.actor", "actors.assembler",
    "actors.act_dispatch", "actors.transport", "ingest", "ingest.codec",
    "ingest.schema", "ingest.router", "ingest.shm_ring", "envs.gym_adapter",
    "envs.host_pong", "envs.host_breakout", "utils.host_eval", "utils.pow2")}
assert slice9 <= set(names), sorted(slice9 - set(names))
slice10 = {"dist_dqn_tpu_torch." + m for m in (
    "actors.remote", "replay.sharded")}
assert slice10 <= set(names), sorted(slice10 - set(names))
slice11 = {"dist_dqn_tpu_torch." + m for m in (
    "actors.feeder", "envs.fake_ale", "envs.dmc_adapter", "atari57",
    "atari57_refs")}
assert slice11 <= set(names), sorted(slice11 - set(names))
from dist_dqn_tpu_torch.actors.feeder import (FeederSpecEnv,
                                              parse_feeder_spec, run_feeder)
from dist_dqn_tpu_torch.atari57 import (ATARI_57, evaluate_suite,
                                        normalized_scores, train_suite)
from dist_dqn_tpu_torch.atari57_refs import HUMAN_RANDOM_SCORES
from dist_dqn_tpu_torch.envs.dmc_adapter import DMCPixelEnv
from dist_dqn_tpu_torch.envs.fake_ale import FakeALEEnv
from dist_dqn_tpu_torch.evaluate import evaluate_checkpoint_host
from dist_dqn_tpu_torch.ingest.shm_ring import batch_bytes
from dist_dqn_tpu_torch.replay.host import NativeSumTree
from dist_dqn_tpu_torch.actors.actor import run_remote_actor
from dist_dqn_tpu_torch.actors.assembler import (NativeNStepAssembler,
                                                 SequenceAssembler,
                                                 initial_sequence_priorities)
from dist_dqn_tpu_torch.actors.remote import main as remote_main
from dist_dqn_tpu_torch.actors.transport import (TcpRecordClient,
                                                 TcpRecordServer)
from dist_dqn_tpu_torch.replay.sharded import restore_replay_snapshot
from dist_dqn_tpu_torch.actors.service import (ApexLearnerService,
                                               ApexRuntimeConfig, run_apex)
from dist_dqn_tpu_torch.actors.actor import run_actor
from dist_dqn_tpu_torch.replay.host import (PrioritizedHostReplay,
                                            UniformHostReplay, pad_pow2)
from dist_dqn_tpu_torch.host_replay_loop import (CollectCarry,
                                                 make_collect_chunk,
                                                 run_host_replay)
from dist_dqn_tpu_torch.replay.host import (DevicePrioritySampler, SumTree,
                                            make_sum_tree, stratified_mass)
from dist_dqn_tpu_torch.replay.host_ring import (HostTimeRing,
                                                 RingDevicePrioritySampler,
                                                 RingPrioritySampler)
from dist_dqn_tpu_torch.replay.staging import (DoubleBufferedStager,
                                               EvacuationWorker,
                                               SamplePrefetcher,
                                               StreamedEvacuator)
from dist_dqn_tpu_torch.ops.sampler import (SAMPLE_BLOCK,
                                            fixed_order_cumsum,
                                            stratified_sample_rows)
from dist_dqn_tpu_torch.population import (make_population_train,
                                           member_hp, member_seeds)
from dist_dqn_tpu_torch.models import member_forward, stack_networks
from dist_dqn_tpu_torch.models import ImplicitQuantileNetwork, NoisyDense
from dist_dqn_tpu_torch.ops.losses import (categorical_projection,
                                           iqn_quantile_huber_td,
                                           munchausen_bonus)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "dist_dqn_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 41 and bad.strip() == "[]"


_NO_TORCH = r"""
import sys
import dist_dqn_tpu_torch.actors.feeder
import dist_dqn_tpu_torch.envs.fake_ale
import dist_dqn_tpu_torch.atari57_refs
from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env
make_host_env("feeder:pixel", 2).reset()
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("torch", "jax", "dist_dqn_tpu"))
print(bad)
"""


def test_feeder_and_fake_ale_load_no_torch():
    """Feeder processes, like actors, start without torch: the feeder, the
    fake ALE and the reference table import numpy only."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"
