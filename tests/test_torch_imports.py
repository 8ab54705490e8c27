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
slice12 = {"dist_dqn_tpu_torch." + m for m in (
    "serving", "serving.__main__", "serving.batcher", "serving.client",
    "serving.model_store", "serving.router", "serving.server",
    "serving.types", "telemetry", "telemetry.collectors",
    "telemetry.exposition", "telemetry.registry", "telemetry.server",
    "telemetry.watchdog")}
assert slice12 <= set(names), sorted(slice12 - set(names))
slice13 = {"dist_dqn_tpu_torch." + m for m in (
    "parallel", "parallel.distributed", "parallel.mesh", "parallel.learner")}
assert slice13 <= set(names), sorted(slice13 - set(names))
slice16 = {"dist_dqn_tpu_torch." + m for m in (
    "telemetry.lifecycle", "telemetry.manifest", "utils.metrics")}
assert slice16 <= set(names), sorted(slice16 - set(names))
from dist_dqn_tpu_torch.parallel import (Mesh, make_mesh,
                                         make_mesh_fused_train,
                                         make_mesh_r2d2_train)
from dist_dqn_tpu_torch.parallel.learner import (global_metrics,
                                                 make_sharded_train_step,
                                                 scan_train_step_specs,
                                                 train_step_specs)
from dist_dqn_tpu_torch.parallel.distributed import (host_replica,
                                                     initialize,
                                                     is_main_process,
                                                     main_process_log,
                                                     shutdown, spawn)
from dist_dqn_tpu_torch.serving import (ActResult, MicroBatcher, ModelStore,
                                        PolicyServer, PolicySnapshot,
                                        QueueFullError, Router,
                                        ServerClosedError, ServingClient,
                                        ServingError, SloTracker,
                                        UnknownPolicyError, build_server)
from dist_dqn_tpu_torch.telemetry import (Registry, TelemetryServer,
                                          build_manifest, format_stacks,
                                          get_run_manifest, healthz_body,
                                          install_snapshot_dump,
                                          maybe_install_snapshot_from_env,
                                          on_exit, register_health_probe,
                                          render_prometheus,
                                          set_run_manifest, start_server)
from dist_dqn_tpu_torch.telemetry.collectors import (FusedLineageTable,
                                                     histogram_quantile,
                                                     lineage_histograms,
                                                     observe_device_ring,
                                                     observe_sample_lineage,
                                                     replay_gauges)
from dist_dqn_tpu_torch.utils.metrics import MetricLogger, RateTracker
from dist_dqn_tpu_torch.utils.checkpoint import params_prefix
from dist_dqn_tpu_torch.replay.sharded import (ShardedHostReplay,
                                               ShardedPrioritizedReplay,
                                               restore_replay_snapshot,
                                               shard_state,
                                               split_shard_state)
from dist_dqn_tpu_torch.host_replay_loop import (carry_from_leaves,
                                                 carry_leaves,
                                                 compose_sidecar,
                                                 prune_sidecars,
                                                 host_replay_generators,
                                                 resolve_mesh_width)
from dist_dqn_tpu_torch.parallel.learner import sync_learner_from_rank0
from dist_dqn_tpu_torch.utils.checkpoint import (RankCarryShards,
                                                 check_mesh_width)
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
slice15 = {"dist_dqn_tpu_torch." + m for m in (
    "actors.multihost", "actors.learner_ranks")}
assert slice15 <= set(names), sorted(slice15 - set(names))
from dist_dqn_tpu_torch.actors.multihost import MultihostLearner
from dist_dqn_tpu_torch.actors.learner_ranks import (LearnerRanks,
                                                     pick_learner_devices,
                                                     run_learner_rank)
from dist_dqn_tpu_torch.replay.sharded import (ShardSampleService,
                                               ShardSamplerError)
from dist_dqn_tpu_torch.parallel.learner import learner_replicas_equal
slice17 = {"dist_dqn_tpu_torch." + m for m in (
    "telemetry.devtime", "utils.flops", "utils.trace")}
assert slice17 <= set(names), sorted(slice17 - set(names))
from dist_dqn_tpu_torch.telemetry import (IDLE_CAUSES, ProgramRegistry,
                                          UtilizationLedger, capture_profile,
                                          get_program_registry,
                                          maybe_trace_first_chunk,
                                          programs_snapshot,
                                          register_program,
                                          reset_program_registry,
                                          set_learner_mfu,
                                          sweep_device_memory)
from dist_dqn_tpu_torch.utils.flops import (census, chip_peak_flops,
                                            mfu_fields, nature_cnn_fwd_flops,
                                            r2d2_time_model, roofline_fields,
                                            stratified_sample_cost)
from dist_dqn_tpu_torch.utils.trace import (SPAN_BUCKETS, NullTracer,
                                            SpanTracer, make_tracer)
slice18 = {"dist_dqn_tpu_torch." + m for m in (
    "telemetry.flight", "telemetry.fleet")}
assert slice18 <= set(names), sorted(slice18 - set(names))
from dist_dqn_tpu_torch.telemetry import (DivergenceSentinel, FenceLock,
                                          FlightRecorder,
                                          NullFlightRecorder, Watchdog,
                                          dump_forensics, get_flight,
                                          get_watchdog, install_sentinel,
                                          install_watchdog,
                                          maybe_install_from_env,
                                          observe_divergence)
from dist_dqn_tpu_torch.telemetry.fleet import (FleetAggregator,
                                                FleetServer,
                                                merge_expositions,
                                                register_endpoint)
from dist_dqn_tpu_torch.utils.trace import FlightTracer
from dist_dqn_tpu_torch.utils.checkpoint import save_emergency
slice19 = {"dist_dqn_tpu_torch." + m for m in (
    "chaos", "chaos.plan", "chaos.injector", "chaos.run", "utils.sizing",
    "utils.device_cleanup")}
assert slice19 <= set(names), sorted(slice19 - set(names))
from dist_dqn_tpu_torch.chaos import (CHAOS_PLAN_ENV, SEAMS,
                                      ChaosInjectedError, ChaosInjector,
                                      FaultEvent, FaultPlan, corrupt_bytes,
                                      fire, get_injector, install, installed,
                                      maybe_install_from_env,
                                      mark_recovered, sleep_for,
                                      truncate_bytes, uninstall)
from dist_dqn_tpu_torch.chaos.run import PLANS, SCENARIOS, print_plans
from dist_dqn_tpu_torch.utils.sizing import (KNOWN_BAD, PROVEN_SAFE,
                                             SizingVerdict, check_envelope,
                                             fused_gate_args, gate_fused,
                                             predict_fused_hbm_bytes,
                                             predict_fused_seconds)
from dist_dqn_tpu_torch.utils.device_cleanup import install, release
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
import dist_dqn_tpu_torch.actors.actor
import dist_dqn_tpu_torch.actors.remote
import dist_dqn_tpu_torch.envs.fake_ale
import dist_dqn_tpu_torch.atari57_refs
from dist_dqn_tpu_torch import telemetry
from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env
make_host_env("feeder:pixel", 2).reset()
telemetry.build_manifest(argv=["actor"])
telemetry.sweep_device_memory()
telemetry.UtilizationLedger("actor").observe_chunk(1.0, 0.5)
telemetry.register_program("actor.step", loop="actor").count_dispatch()
telemetry.maybe_install_snapshot_from_env(tag="actor0")
from dist_dqn_tpu_torch.telemetry import fleet, flight, watchdog
flight.get_flight().record("queue", "probe", rows=1)
watchdog.heartbeat("actor.loop").beat()
fleet.merge_expositions([{"text": "dqn_x 1\n", "labels": {"role": "a"}}])
from dist_dqn_tpu_torch import chaos
with chaos.installed(chaos.FaultPlan.generate(1, ["actor.step"])) as inj:
    assert [chaos.fire("actor.step") for _ in range(2)][0] is None
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("torch", "jax", "dist_dqn_tpu")
             or k.startswith("dist_dqn_tpu_torch.utils"))
print(bad)
"""


def test_feeder_and_fake_ale_load_no_torch():
    """Feeder and actor processes start without torch: the feeder, the
    actors, the fake ALE, the reference table and the telemetry plane
    (its manifest, exit snapshot and chip-time plane's ledger, program
    table and memory sweep, the flight recorder, the watchdog and the
    fleet plane included) and the chaos plane they arm import numpy
    only, and nothing of utils/."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


_SERVING_HELP = r"""
import runpy, sys
sys.argv = ["dist_dqn_tpu_torch.serving", "--help"]
try:
    runpy.run_module("dist_dqn_tpu_torch.serving", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "dist_dqn_tpu"))
print(bad)
"""


def test_serving_cli_help_loads_no_jax():
    """``python -m dist_dqn_tpu_torch.serving --help`` prints its flags
    without loading JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SERVING_HELP], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--checkpoint-dir" in proc.stdout and "--device" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1] == "[]"


_DQNLINT = r"""
import io, json, runpy, sys
from contextlib import redirect_stdout
sys.argv = ["dist_dqn_tpu_torch.analysis", "--all", "--json"]
out = io.StringIO()
try:
    with redirect_stdout(out):
        runpy.run_module("dist_dqn_tpu_torch.analysis", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, (e.code, out.getvalue()[-2000:])
payload = json.loads(out.getvalue())
assert payload["ok"] and payload["summary"]["checks_run"] == 11, payload
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("torch", "jax", "jaxlib", "dist_dqn_tpu"))
print(bad)
"""


def test_dqnlint_loads_no_torch_no_jax_no_reference_package():
    """``python -m dist_dqn_tpu_torch.analysis --all --json`` runs all
    eleven checks with the standard library alone: no torch, no JAX and
    nothing of dist_dqn_tpu (the wire and ckpt-schema checks import the
    port's framework-free codec and schema modules)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _DQNLINT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
