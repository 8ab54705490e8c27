"""One Ape-X service run of either package at a small size, in a process
of its own, for tests/test_torch_telemetry_runtimes.py: the service spawns
actor processes, so it runs from a file (never from stdin) and the test
bounds it with a subprocess time limit.

    python tests/torch_telemetry_workers.py {jax,torch} [TRACE_PATH [KW]]

prints one JSON line: the run's summary and its registry's metric families
as ``[name, kind, [label keys]]``, with every series' value; with
``TRACE_PATH`` the service writes its host-loop spans there (``trace_path``)
and the line carries the trace's event names. ``KW`` is a JSON object of
further ``ApexRuntimeConfig`` fields for the port's run."""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RT = dict(host_env="CartPole-v1", num_actors=1, envs_per_actor=4,
          total_env_steps=800, inserts_per_grad_step=64, log_every_s=0.2)


def _tiny(cfg):
    return dataclasses.replace(
        cfg,
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(16,), hidden=0,
                                    compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=1024, min_fill=64),
        learner=dataclasses.replace(cfg.learner, batch_size=16))


def families(reg) -> list:
    """[name, kind, sorted label keys] of every series, deduplicated."""
    out = set()
    for name, insts in reg.collect().items():
        for inst in insts:
            out.add((name, inst.kind, tuple(sorted(inst.labels or {}))))
    return sorted([n, k, list(ls)] for n, k, ls in out)


def values(reg) -> dict:
    return {k: v.get("value", v.get("count"))
            for k, v in reg.snapshot().items()}


def main(pkg: str, trace_path: str = None, kw: str = "{}") -> None:
    if pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from dist_dqn_tpu.actors.service import ApexRuntimeConfig, run_apex
        from dist_dqn_tpu.config import CONFIGS
        from dist_dqn_tpu.telemetry import get_registry
        summary = run_apex(_tiny(CONFIGS["cartpole"]),
                           ApexRuntimeConfig(**RT, trace_path=trace_path),
                           log_fn=lambda s: None)
    else:
        import torch
        torch.set_num_threads(1)
        from dist_dqn_tpu_torch.actors.service import (ApexRuntimeConfig,
                                                       run_apex)
        from dist_dqn_tpu_torch.config import CONFIGS
        from dist_dqn_tpu_torch.telemetry import get_registry
        rt = {**RT, "telemetry_port": 0, "trace_path": trace_path,
              **json.loads(kw)}
        summary = run_apex(_tiny(CONFIGS["cartpole"]),
                           ApexRuntimeConfig(**rt), log_fn=lambda s: None,
                           device="cpu")
    reg = get_registry()
    keep = ("env_steps", "grad_steps", "replay_size", "records_by_shard",
            "ingest_bytes", "ingest_passes", "episodes_completed",
            "device_calls", "chip_time", "programs", "learner_devices",
            "learner_replicas_equal", "shard_sampling")
    names = None
    if trace_path:
        with open(trace_path) as f:
            names = sorted({e["name"] for e in json.load(f)})
    print(json.dumps({"summary": {k: summary.get(k) for k in keep},
                      "families": families(reg), "values": values(reg),
                      "trace_names": names}, default=str))


if __name__ == "__main__":
    main(*sys.argv[1:])
