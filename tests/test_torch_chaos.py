"""The port's chaos plane (dist_dqn_tpu_torch/chaos/ and its seams), twin
of JAX's ``tests/test_chaos.py``, case for case, plus parity anchors
against the JAX package:

* ``SEAMS`` equal to JAX's; ``FaultPlan.generate`` and its JSON byte-equal
  to JAX's for several seeds, seam lists and knobs; the game-day runner's
  ``--print-plan`` byte-equal to ``scripts/chaos_run.py --print-plan``;
* the seeded smoke's ``(seam, fault, hit)`` list equal to the one JAX's
  ``run_host_replay`` injects under the same plan and run shape;
* a port-only case for the ``replay.device_sample`` seam on the plain
  (CPU) draw: the injected exception raises before the pending writes
  flush, and the next draw equals an unfaulted plane's.

Everything runs on the CPU at the JAX tests' sizes (8 CartPole lanes, an
MLP of 32, a 4,096-slot ring, batches of 16).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dist_dqn_tpu_torch import chaos
from dist_dqn_tpu_torch.chaos.run import host_replay_cfg

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quiet(_line):
    pass


# ---------------------------------------------------------------------------
# FaultPlan: seeded, validated, replayable
# ---------------------------------------------------------------------------

class TestFaultPlan:
    def test_same_seed_same_plan(self):
        seams = ["transport.send", "evac.drain", "checkpoint.save"]
        a = chaos.FaultPlan.generate(7, seams, events_per_seam=2)
        b = chaos.FaultPlan.generate(7, seams, events_per_seam=2)
        assert a.to_json() == b.to_json()
        assert len(a.events) == 6
        # A different seed must actually move the schedule.
        c = chaos.FaultPlan.generate(8, seams, events_per_seam=2)
        assert a.to_json() != c.to_json()
        # Round-trip: the manifest/env representation is lossless.
        assert chaos.FaultPlan.from_json(a.to_json()) == a

    def test_unknown_seam_and_fault_fail_at_build_time(self):
        with pytest.raises(ValueError, match="unknown chaos seam"):
            chaos.FaultEvent(seam="transport.teleport", fault="drop",
                             at_hit=1)
        with pytest.raises(ValueError, match="does not interpret"):
            chaos.FaultEvent(seam="transport.send", fault="wedge",
                             at_hit=1)
        with pytest.raises(ValueError, match="exactly one"):
            chaos.FaultEvent(seam="transport.send", fault="drop")

    def test_for_seams_slices_per_process(self):
        plan = chaos.FaultPlan.generate(
            3, ["transport.send", "evac.drain"], events_per_seam=2)
        sub = plan.for_seams(["evac.drain"])
        assert sub.seed == plan.seed
        assert {e.seam for e in sub.events} == {"evac.drain"}
        assert len(sub.events) == 2

    def test_generated_faults_are_interpretable(self):
        """Every seam/fault pair generate() can emit is in the
        registry, and parameterized faults carry their args."""
        plan = chaos.FaultPlan.generate(11, sorted(chaos.SEAMS),
                                        events_per_seam=3)
        for ev in plan.events:
            assert ev.fault in chaos.SEAMS[ev.seam]
            if ev.fault == "bit_flip":
                assert "bit" in ev.args
            if ev.fault == "truncate":
                assert 0.0 < ev.args["keep_frac"] < 1.0


class TestJaxParity:
    """The port's plans are the JAX package's, byte for byte."""

    def test_seams_equal_jax(self):
        from dist_dqn_tpu.chaos import plan as jplan

        assert chaos.SEAMS == jplan.SEAMS
        assert list(chaos.SEAMS) == list(jplan.SEAMS)

    @pytest.mark.parametrize("seed", [0, 1, 7, 12345])
    def test_generated_plans_are_byte_equal(self, seed):
        from dist_dqn_tpu.chaos import plan as jplan

        for seams, knobs in (
                (sorted(chaos.SEAMS), dict(events_per_seam=3)),
                (["transport.send", "evac.drain", "checkpoint.save"],
                 dict(events_per_seam=2, max_hit=9, horizon_s=4.0)),
                (["replay.device_sample", "serving.reload"], {})):
            ours = chaos.FaultPlan.generate(seed, seams, **knobs)
            theirs = jplan.FaultPlan.generate(seed, seams, **knobs)
            assert ours.to_json() == theirs.to_json()
            assert ours.to_dict() == theirs.to_dict()
            # Each package reads the other's JSON back to the same plan.
            assert chaos.FaultPlan.from_json(theirs.to_json()) == ours
            sub = ours.for_seams(seams[:1]).to_json()
            assert sub == theirs.for_seams(seams[:1]).to_json()

    def test_chaos_families_render_as_jax_renders_them(self):
        """The injector's two families (the writers in
        telemetry/collectors.py) scrape as JAX's: the same HELP and TYPE
        lines, label sets and counts after the same injections and
        recoveries (the recovery seconds themselves are wall time)."""
        from dist_dqn_tpu import chaos as jchaos
        from dist_dqn_tpu.telemetry.exposition import \
            render_prometheus as jrender
        from dist_dqn_tpu.telemetry.registry import Registry as JRegistry
        from dist_dqn_tpu_torch.telemetry.exposition import render_prometheus
        from dist_dqn_tpu_torch.telemetry.registry import Registry

        plan = chaos.FaultPlan(seed=3, events=(
            chaos.FaultEvent("evac.drain", "stall", at_hit=1,
                             args={"delay_s": 0.0}),
            chaos.FaultEvent("transport.send", "drop", at_hit=2)))

        def scrape(pkg, reg, render):
            with pkg.installed(pkg.FaultPlan.from_json(plan.to_json()),
                               registry=reg):
                for seam in ("evac.drain", "transport.send",
                             "transport.send"):
                    pkg.fire(seam)
                pkg.mark_recovered("evac.drain")
            return [line for line in render(reg).splitlines()
                    if not line.startswith("dqn_recovery_seconds_sum")
                    and not line.startswith("dqn_recovery_seconds_bucket")]

        assert scrape(chaos, Registry(), render_prometheus) == \
            scrape(jchaos, JRegistry(), jrender)

    def test_print_plan_is_byte_equal_to_the_jax_runner(self):
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        for seed in (0, 7):
            ours = subprocess.run(
                [sys.executable, "-m", "dist_dqn_tpu_torch.chaos.run",
                 "--seed", str(seed), "--print-plan"],
                capture_output=True, cwd=REPO, timeout=120, env=env)
            theirs = subprocess.run(
                [sys.executable, "scripts/chaos_run.py", "--seed",
                 str(seed), "--print-plan"],
                capture_output=True, cwd=REPO, timeout=120, env=env)
            assert ours.returncode == theirs.returncode == 0, \
                (ours.stderr, theirs.stderr)
            assert ours.stdout == theirs.stdout
            assert json.loads(ours.stdout)["ckpt_crash"]["seed"] == seed

    def test_smoke_injects_what_jax_injects(self, tmp_path):
        """The seeded smoke's (seam, fault, hit) list on the port equals
        the one JAX's ``run_host_replay`` injects under the same plan
        and run shape."""
        import dataclasses as dc

        from dist_dqn_tpu import chaos as jchaos
        from dist_dqn_tpu.config import CONFIGS as JCONFIGS
        from dist_dqn_tpu.host_replay_loop import run_host_replay as jrun
        from dist_dqn_tpu.telemetry.registry import Registry as JRegistry
        from dist_dqn_tpu_torch.host_replay_loop import run_host_replay
        from dist_dqn_tpu_torch.telemetry.registry import Registry

        jcfg = JCONFIGS["cartpole"]
        jcfg = dc.replace(
            jcfg, actor=dc.replace(jcfg.actor, num_envs=8),
            network=dc.replace(jcfg.network, torso="mlp",
                               mlp_features=(32,), hidden=0,
                               compute_dtype="float32"),
            replay=dc.replace(jcfg.replay, capacity=4096, min_fill=64,
                              prioritized=False),
            learner=dc.replace(jcfg.learner, batch_size=16))
        kw = dict(total_env_steps=3200, chunk_iters=50,
                  save_every_frames=800)
        plan = _smoke_plan()
        jplan = jchaos.FaultPlan.from_json(plan.to_json())
        with jchaos.installed(jplan, registry=JRegistry()) as jinj:
            jrun(jcfg, log_fn=_quiet, checkpoint_dir=str(tmp_path / "jax"),
                 **kw)
            theirs = sorted((e["seam"], e["fault"], e["hit"])
                            for e in jinj.injected)
        with chaos.installed(plan, registry=Registry()) as inj:
            run_host_replay(host_replay_cfg(), log_fn=_quiet, device="cpu",
                            checkpoint_dir=str(tmp_path / "port"), **kw)
            ours = sorted((e["seam"], e["fault"], e["hit"])
                          for e in inj.injected)
        assert ours == theirs == sorted(
            (e.seam, e.fault, e.at_hit) for e in plan.events)


class TestInjector:
    def test_fires_exactly_once_at_hit(self):
        from dist_dqn_tpu_torch.telemetry.registry import Registry

        plan = chaos.FaultPlan(seed=1, events=(
            chaos.FaultEvent("evac.drain", "exception", at_hit=3),))
        with chaos.installed(plan, registry=Registry()) as inj:
            fired = [chaos.fire("evac.drain") for _ in range(6)]
        hits = [ev for ev in fired if ev is not None]
        assert len(hits) == 1 and fired[2] is hits[0]
        assert inj.injected == [{"seam": "evac.drain",
                                 "fault": "exception", "hit": 3,
                                 "t_s": inj.injected[0]["t_s"]}]
        # Unarmed fire() is a no-op returning None.
        assert chaos.fire("evac.drain") is None

    def test_recovery_metric_closes_open_trip(self):
        from dist_dqn_tpu_torch.telemetry import flight
        from dist_dqn_tpu_torch.telemetry.registry import Registry

        reg = Registry()
        plan = chaos.FaultPlan(seed=1, events=(
            chaos.FaultEvent("evac.drain", "stall", at_hit=1,
                             args={"delay_s": 0.0}),))
        with chaos.installed(plan, registry=reg) as inj:
            chaos.fire("evac.drain")
            assert inj.open_trips() == ["evac.drain"]
            chaos.mark_recovered("evac.drain")
            assert inj.open_trips() == []
            # Recovery without an open trip is a no-op, so call sites
            # mark unconditionally.
            assert inj.mark_recovered("evac.drain") is None
        fams = reg.collect()
        assert fams["dqn_chaos_injected_total"][0].value == 1
        assert fams["dqn_chaos_injected_total"][0].labels == {
            "seam": "evac.drain", "fault": "stall"}
        assert fams["dqn_recovery_seconds"][0].count == 1
        # Both ends land in the flight recorder's ring.
        names = [e["name"] for e in flight.get_flight().tail()
                 if e["kind"] == "chaos"]
        assert names[-2:] == ["evac.drain.stall", "evac.drain.recovered"]

    def test_env_arming_and_manifest_provenance(self, monkeypatch):
        from dist_dqn_tpu_torch.telemetry import manifest as manifest_mod

        plan = chaos.FaultPlan.generate(5, ["actor.step"])
        monkeypatch.setenv(chaos.CHAOS_PLAN_ENV, plan.to_json())
        try:
            inj = chaos.maybe_install_from_env()
            assert inj is not None and inj.plan == plan
            # Arming annotates the run manifest: the forensics bundle /
            # provenance of any chaos run names its schedule.
            man = manifest_mod.get_run_manifest()
            assert man is not None
            assert chaos.FaultPlan.from_dict(man["chaos_plan"]) == plan
        finally:
            chaos.uninstall()

    def test_malformed_env_plan_fails_loudly(self, monkeypatch):
        monkeypatch.setenv(chaos.CHAOS_PLAN_ENV, '{"seed": 1, "events": '
                           '[{"seam": "nope", "fault": "x", "at_hit": 1}]}')
        with pytest.raises(ValueError, match="unknown chaos seam"):
            chaos.maybe_install_from_env()
        assert chaos.get_injector() is None


# ---------------------------------------------------------------------------
# Transport: a flipped bit never reaches the array codec
# ---------------------------------------------------------------------------

class TestTransportChaos:
    def _push_and_collect(self, server, client, payloads, want,
                          timeout_s=20.0):
        """Push ``payloads`` then pop until ``want`` records arrived."""
        for p in payloads:
            client.push(p)
        got = []
        deadline = time.monotonic() + timeout_s
        while len(got) < want and time.monotonic() < deadline:
            rec = server.pop()
            if rec is None:
                time.sleep(0.002)
                continue
            got.append(rec[1])
        return got

    def test_payload_bit_flip_dropped_counted_nacked(self):
        """THE corrupt-frame pin: a bit flipped in a frame's payload on
        the wire is dropped at the server's CRC gate (never decoded),
        counted under {reason="crc"}, and the sender is NACKed so its
        lock-step lane reconnects immediately — while the CONNECTION
        survives and later frames flow."""
        from dist_dqn_tpu_torch.actors.transport import (
            CORRUPT_FRAME_NACK_KIND, TcpRecordClient, TcpRecordServer,
            decode_arrays, encode_arrays)

        # bit 200 sits past the 12-byte frame header: payload damage,
        # trustworthy boundary — the single-frame-drop path.
        plan = chaos.FaultPlan(seed=2, events=(
            chaos.FaultEvent("transport.send", "bit_flip", at_hit=2,
                             args={"bit": 200}),))
        server = TcpRecordServer(host="127.0.0.1")
        client = None
        try:
            with chaos.installed(plan) as inj:
                client = TcpRecordClient(server.address)
                frames = [encode_arrays({"x": np.full((64,), i, np.int64)},
                                        {"i": i}) for i in range(4)]
                got = self._push_and_collect(server, client, frames,
                                             want=3)
            # Frame 1 (0-based) was corrupted: exactly the other three
            # decode, in order, bit-exact.
            assert [decode_arrays(p)[1]["i"] for p in got] == [0, 2, 3]
            assert server.corrupt_frames == 1
            assert [e["fault"] for e in inj.injected] == ["bit_flip"]
            # The NACK reached the sender's reply channel.
            reply = client.read_reply(keep_waiting=lambda: True)
            _, meta = decode_arrays(reply)
            assert meta["kind"] == CORRUPT_FRAME_NACK_KIND
            # The server proved recovery (valid frames after the drop).
            assert "transport.recv" not in inj.open_trips()
        finally:
            if client is not None:
                client.close()
            server.close()

    def test_header_flip_desyncs_connection_reconnect_recovers(self):
        """A flip inside the frame HEADER leaves no trustworthy
        boundary: the server drops the connection (bad_magic), and a
        reconnect — the remote actor's organic response to a dead
        reply stream — fully recovers the lane."""
        from dist_dqn_tpu_torch.actors.transport import (TcpRecordClient,
                                                         TcpRecordServer,
                                                         decode_arrays,
                                                         encode_arrays)

        plan = chaos.FaultPlan(seed=3, events=(
            chaos.FaultEvent("transport.send", "bit_flip", at_hit=1,
                             args={"bit": 5}),))    # inside magic
        server = TcpRecordServer(host="127.0.0.1")
        c1 = c2 = None
        try:
            with chaos.installed(plan):
                c1 = TcpRecordClient(server.address)
                c1.push(encode_arrays({"x": np.zeros(3)}, {"i": 0}))
                deadline = time.monotonic() + 20.0
                while (server.corrupt_frames < 1
                       and time.monotonic() < deadline):
                    time.sleep(0.002)
                assert server.corrupt_frames == 1
                assert server.pop() is None
                # Reconnect: the recovered lane carries frames again.
                c2 = TcpRecordClient(server.address)
                got = self._push_and_collect(
                    server, c2,
                    [encode_arrays({"x": np.arange(3)}, {"i": 1})], 1)
            assert decode_arrays(got[0])[1]["i"] == 1
        finally:
            for c in (c1, c2):
                if c is not None:
                    c.close()
            server.close()

    def test_truncated_frame_counted_and_stream_recovers(self):
        """A half-written frame (sender died mid-send) is counted as
        truncated; push() reports the failure so the caller reconnects."""
        from dist_dqn_tpu_torch.actors.transport import (TcpRecordClient,
                                                         TcpRecordServer,
                                                         decode_arrays,
                                                         encode_arrays)

        plan = chaos.FaultPlan(seed=4, events=(
            chaos.FaultEvent("transport.send", "truncate", at_hit=2,
                             args={"keep_frac": 0.5}),))
        server = TcpRecordServer(host="127.0.0.1")
        c1 = c2 = None
        try:
            with chaos.installed(plan):
                c1 = TcpRecordClient(server.address)
                payload = encode_arrays({"x": np.zeros((256,))}, {"i": 0})
                assert c1.push(payload)
                assert not c1.push(payload)   # truncated + closed
                deadline = time.monotonic() + 20.0
                while (server.corrupt_frames < 1
                       and time.monotonic() < deadline):
                    time.sleep(0.002)
                assert server.corrupt_frames == 1
                c2 = TcpRecordClient(server.address)
                got = self._push_and_collect(
                    server, c2,
                    [encode_arrays({"x": np.arange(4)}, {"i": 7})], 2)
            # The good frame before the kill plus the reconnect's frame
            # both decode; the torn one never reached the codec.
            assert sorted(decode_arrays(p)[1]["i"] for p in got) == [0, 7]
        finally:
            for c in (c1, c2):
                if c is not None:
                    c.close()
            server.close()

    def test_recv_disconnect_drops_connection_only(self):
        """Server-side injected disconnect (the partition fault): the
        connection dies, the process and listener survive, and a fresh
        connection serves immediately."""
        from dist_dqn_tpu_torch.actors.transport import (TcpRecordClient,
                                                         TcpRecordServer,
                                                         decode_arrays,
                                                         encode_arrays)

        plan = chaos.FaultPlan(seed=5, events=(
            chaos.FaultEvent("transport.recv", "disconnect", at_hit=2),))
        server = TcpRecordServer(host="127.0.0.1")
        c1 = c2 = None
        try:
            with chaos.installed(plan):
                c1 = TcpRecordClient(server.address)
                got = self._push_and_collect(
                    server, c1,
                    [encode_arrays({"x": np.zeros(2)}, {"i": 0})], 1)
                c1.push(encode_arrays({"x": np.zeros(2)}, {"i": 1}))
                # The dropped connection surfaces as a dead reply stream.
                assert c1.read_reply(keep_waiting=lambda: True) is None
                c2 = TcpRecordClient(server.address)
                got += self._push_and_collect(
                    server, c2,
                    [encode_arrays({"x": np.zeros(2)}, {"i": 2})], 1)
            assert [decode_arrays(p)[1]["i"] for p in got] == [0, 2]
        finally:
            for c in (c1, c2):
                if c is not None:
                    c.close()
            server.close()


# ---------------------------------------------------------------------------
# Pipeline workers: injected failures ride the organic contracts
# ---------------------------------------------------------------------------

class TestPipelineWorkerChaos:
    def test_evac_injected_exception_tombstones_like_organic(self):
        from dist_dqn_tpu_torch.replay.staging import (EvacuationWorker,
                                                       StreamedEvacuator)

        plan = chaos.FaultPlan(seed=6, events=(
            chaos.FaultEvent("evac.drain", "exception", at_hit=1),))
        ev = StreamedEvacuator(num_slices=2, name="chaos_evac")
        w = EvacuationWorker(ev, lambda tree, lo, hi: None,
                             name="chaos_evac")
        try:
            with chaos.installed(plan):
                h = w.submit({"x": torch.ones((4, 2, 3))})
                with pytest.raises(chaos.ChaosInjectedError,
                                   match="evac.drain"):
                    h.wait(timeout=30)
                # Tombstone: the worker is dead, later submits refuse.
                with pytest.raises(RuntimeError, match="worker died"):
                    w.submit({"x": torch.ones((4, 2, 3))})
        finally:
            w.close()
        assert not w._thread.is_alive()

    def test_prefetch_injected_exception_reraises_at_pop(self):
        from dist_dqn_tpu_torch.replay.staging import SamplePrefetcher

        plan = chaos.FaultPlan(seed=6, events=(
            chaos.FaultEvent("prefetch.sample", "exception", at_hit=1),))
        p = SamplePrefetcher(
            lambda k: ({"x": np.zeros((4, 2), np.float32)}, None),
            depth=2, wait_generation=lambda g, timeout=None: True,
            name="chaos_prefetch", device="cpu")
        try:
            with chaos.installed(plan):
                p.request(1, 0)
                with pytest.raises(chaos.ChaosInjectedError,
                                   match="prefetch.sample"):
                    p.pop(0)
        finally:
            p.close()


# ---------------------------------------------------------------------------
# Checkpoint: disk-full surfaces; torn/missing LATEST falls back
# ---------------------------------------------------------------------------

class TestCheckpointChaos:
    def _state(self):
        return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": torch.full((1,), 1.5)}

    def test_disk_full_save_surfaces_loudly(self, tmp_path):
        from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer

        plan = chaos.FaultPlan(seed=7, events=(
            chaos.FaultEvent("checkpoint.save", "fail", at_hit=1),))
        ckpt = TrainCheckpointer(str(tmp_path), save_every_frames=1)
        try:
            with chaos.installed(plan):
                with pytest.raises(OSError, match="disk-full"):
                    ckpt.save(100, self._state())
            # The failed save left nothing behind to resume from.
            assert ckpt.latest_step() is None
            # The NEXT save recovers the checkpointer.
            ckpt.save(200, self._state())
            ckpt.wait()
            assert ckpt.latest_step() == 200
        finally:
            ckpt.close()

    def test_torn_latest_pointer_falls_back_to_listing(self, tmp_path):
        from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                         read_latest_pointer)

        plan = chaos.FaultPlan(seed=7, events=(
            chaos.FaultEvent("latest.write", "torn", at_hit=2),))
        ckpt = TrainCheckpointer(str(tmp_path), save_every_frames=1)
        try:
            with chaos.installed(plan) as inj:
                ckpt.save(100, self._state())
                ckpt.wait()
                assert read_latest_pointer(str(tmp_path))["step"] == 100
                ckpt.save(200, self._state())   # stamp is torn
                ckpt.wait()
                # The torn stamp is rejected, not trusted...
                assert read_latest_pointer(str(tmp_path)) is None
                # ...and the listing fallback still finds the newest
                # COMMITTED step: readers never regress, never crash.
                assert ckpt.latest_step() == 200
                step, tree = ckpt.restore_latest(self._state())
                assert step == 200
                torch.testing.assert_close(tree["w"], self._state()["w"])
                # The next save re-stamps: recovery proven.
                ckpt.save(300, self._state())
                ckpt.wait()
                assert read_latest_pointer(str(tmp_path))["step"] == 300
                assert "latest.write" not in inj.open_trips()
        finally:
            ckpt.close()

    def test_crash_between_commit_and_stamp(self, tmp_path):
        """The crash window the listing fallback exists for: the step
        commits but LATEST never lands — resume still finds it."""
        from dist_dqn_tpu_torch.utils.checkpoint import (TrainCheckpointer,
                                                         read_latest_pointer)

        plan = chaos.FaultPlan(seed=7, events=(
            chaos.FaultEvent("checkpoint.save", "crash_before_stamp",
                             at_hit=1),))
        ckpt = TrainCheckpointer(str(tmp_path), save_every_frames=1)
        try:
            with chaos.installed(plan):
                ckpt.save(100, self._state())
                ckpt.wait()
            assert read_latest_pointer(str(tmp_path)) is None
            assert ckpt.latest_step() == 100
        finally:
            ckpt.close()


# ---------------------------------------------------------------------------
# Host-replay kill + resume: bit-identical to uninterrupted
# ---------------------------------------------------------------------------

def _losses(out):
    return [r["loss"] for r in out["history"] if "loss" in r]


class TestResumeBitIdentical:
    def test_killed_at_chunk_k_resumes_bit_identical(self, tmp_path):
        """THE resume pin: run B is killed by an injected crash at its
        4th chunk (right after that chunk's checkpoint) and resumed;
        its final params must equal — bit for bit — run A, which was
        never interrupted AND never checkpointed."""
        from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

        cfg = host_replay_cfg()
        kw = dict(total_env_steps=3200, chunk_iters=50, device="cpu")
        out_a = run_host_replay(cfg, **kw, log_fn=_quiet)

        ckpt_dir = str(tmp_path / "host_ckpt")
        plan = chaos.FaultPlan(seed=9, events=(
            chaos.FaultEvent("host_replay.chunk", "crash", at_hit=4),))
        with chaos.installed(plan) as inj:
            with pytest.raises(chaos.ChaosInjectedError,
                               match="host_replay.chunk"):
                run_host_replay(cfg, **kw, log_fn=_quiet,
                                checkpoint_dir=ckpt_dir,
                                save_every_frames=400)
            assert [e["hit"] for e in inj.injected] == [4]

        logs = []
        out_b = run_host_replay(cfg, **kw, checkpoint_dir=ckpt_dir,
                                save_every_frames=400, log_fn=logs.append)
        resumed = [json.loads(s) for s in logs
                   if "resumed_at_frames" in s]
        assert resumed and resumed[0]["resumed_at_frames"] == 1600
        assert out_b["param_checksum"] == out_a["param_checksum"]
        assert out_b["grad_steps"] == out_a["grad_steps"]
        # The resumed run's per-chunk losses match the uninterrupted
        # run's tail — the whole trajectory, not just the endpoint.
        losses_a, losses_b = _losses(out_a), _losses(out_b)
        assert losses_b == losses_a[len(losses_a) - len(losses_b):]

    def test_per_killed_resume_bit_identical_serial(self, tmp_path):
        """The PER twin of the resume pin: serial PER (no prefetch)
        killed at chunk k and resumed matches the uninterrupted,
        never-checkpointed run bit for bit — params, the whole loss
        trajectory AND the priority accounting."""
        from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

        cfg = host_replay_cfg()
        cfg = dataclasses.replace(
            cfg, replay=dataclasses.replace(cfg.replay, prioritized=True))
        # prio_writeback_batch chosen so a save boundary lands with the
        # pending list NON-empty.
        kw = dict(total_env_steps=3200, chunk_iters=50, prefetch=False,
                  prio_writeback_batch=4, device="cpu")
        out_a = run_host_replay(cfg, **kw, log_fn=_quiet)

        ckpt_dir = str(tmp_path / "per_ckpt")
        plan = chaos.FaultPlan(seed=9, events=(
            chaos.FaultEvent("host_replay.chunk", "crash", at_hit=4),))
        with chaos.installed(plan):
            with pytest.raises(chaos.ChaosInjectedError,
                               match="host_replay.chunk"):
                run_host_replay(cfg, **kw, log_fn=_quiet,
                                checkpoint_dir=ckpt_dir,
                                save_every_frames=400)
        out_b = run_host_replay(cfg, **kw, checkpoint_dir=ckpt_dir,
                                save_every_frames=400, log_fn=_quiet)
        assert out_b["param_checksum"] == out_a["param_checksum"]
        assert out_b["grad_steps"] == out_a["grad_steps"]
        losses_a, losses_b = _losses(out_a), _losses(out_b)
        assert losses_b == losses_a[len(losses_a) - len(losses_b):]
        assert out_b["prio_writeback_rows"] == out_a["prio_writeback_rows"]
        assert out_b["prio_writeback_flushes"] == \
            out_a["prio_writeback_flushes"]

    def test_extension_resume_continues_completed_run(self, tmp_path):
        """Resuming a COMPLETED run's checkpoint with a LARGER total
        continues as a fresh prologue dispatch against the restored
        ring and params (a continuation, not the bit-identical pin)."""
        from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

        cfg = host_replay_cfg()
        ckpt_dir = str(tmp_path / "ext_ckpt")
        kw = dict(chunk_iters=50, checkpoint_dir=ckpt_dir,
                  save_every_frames=400, device="cpu")
        first = run_host_replay(cfg, **kw, total_env_steps=1600,
                                log_fn=_quiet)
        logs = []
        out = run_host_replay(cfg, **kw, total_env_steps=3200,
                              log_fn=logs.append)
        resumed = [json.loads(s) for s in logs
                   if "resumed_at_frames" in s]
        assert resumed and resumed[0]["resumed_at_frames"] == 1600
        assert out["env_steps"] == 3200
        assert out["grad_steps"] > first["grad_steps"]
        assert np.isfinite(out["param_checksum"])

    def test_mismatched_resume_refused_loudly(self, tmp_path):
        """The sidecar pins: a checkpoint written under one loop shape or
        sampler refuses a differently-configured resume with the actual
        cause named — never a silently-wrong run."""
        from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

        cfg = host_replay_cfg()
        ckpt_dir = str(tmp_path / "pin_ckpt")
        kw = dict(total_env_steps=1600, chunk_iters=50, log_fn=_quiet,
                  checkpoint_dir=ckpt_dir, save_every_frames=400,
                  device="cpu")
        run_host_replay(cfg, **kw)
        with pytest.raises(ValueError, match="chunk-iters"):
            run_host_replay(cfg, total_env_steps=1600, chunk_iters=25,
                            log_fn=_quiet, checkpoint_dir=ckpt_dir,
                            save_every_frames=400, device="cpu")
        per_cfg = dataclasses.replace(
            cfg, replay=dataclasses.replace(cfg.replay, prioritized=True))
        with pytest.raises(ValueError, match="prioritized"):
            run_host_replay(per_cfg, **kw)
        # PER flush-cadence pin: a checkpointed PER run refuses a
        # different prio_writeback_batch.
        per_dir = str(tmp_path / "per_pin")
        run_host_replay(per_cfg, total_env_steps=1600, chunk_iters=50,
                        prefetch=False, prio_writeback_batch=4,
                        log_fn=_quiet, checkpoint_dir=per_dir,
                        save_every_frames=400, device="cpu")
        with pytest.raises(ValueError, match="write-back cadence"):
            run_host_replay(per_cfg, total_env_steps=1600,
                            chunk_iters=50, prefetch=False,
                            prio_writeback_batch=2, log_fn=_quiet,
                            checkpoint_dir=per_dir, save_every_frames=400,
                            device="cpu")

    def test_torn_sidecar_falls_back_to_previous_step(self, tmp_path):
        """A committed step whose sidecar is torn is not a checkpoint:
        resume must delete it, fall back to the previous intact step,
        and the continuing run must be able to RE-SAVE at the same frame
        cursor."""
        import glob

        from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

        cfg = host_replay_cfg()
        ckpt_dir = str(tmp_path / "torn_ckpt")
        kw = dict(total_env_steps=3200, chunk_iters=50,
                  checkpoint_dir=ckpt_dir, save_every_frames=400,
                  device="cpu")
        # One save per 400-frame chunk: the 4th save (1600 frames) is
        # torn, and the run is killed right after it — so the NEWEST
        # step is the unusable one and resume must fall back.
        plan = chaos.FaultPlan(seed=3, events=(
            chaos.FaultEvent("sidecar.write", "torn", at_hit=4),
            chaos.FaultEvent("host_replay.chunk", "crash", at_hit=4),))
        with chaos.installed(plan) as inj:
            with pytest.raises(chaos.ChaosInjectedError):
                run_host_replay(cfg, **kw, log_fn=_quiet)
            assert sorted(e["seam"] for e in inj.injected) == \
                ["host_replay.chunk", "sidecar.write"]
            logs = []
            out = run_host_replay(cfg, **kw, log_fn=logs.append)
            # The torn newest step (save 4 = frames 1600) was deleted;
            # resume fell back to the previous intact step (1200).
            resumed = [json.loads(s) for s in logs
                       if "resumed_at_frames" in s]
            assert resumed and resumed[0]["resumed_at_frames"] == 1200
            fallback = [s for s in logs if "sidecar unreadable" in s]
            assert fallback, "no loud fallback log line"
            assert inj.open_trips() == [], inj.open_trips()
        assert out["env_steps"] == 3200
        steps = sorted(int(p.split("_")[-1][:-4]) for p in glob.glob(
            str(tmp_path / "torn_ckpt" / "host_loop_*.npz")))
        assert 3200 in steps


def test_emergency_hooks_bounded_and_snapshot_restorable(tmp_path):
    """A watchdog abort runs emergency-checkpoint hooks on a bounded side
    thread — a hook that saves lands a restorable side snapshot, a hook
    that WEDGES is abandoned at the timeout instead of blocking the
    abort, and both outcomes are logged honestly."""
    from dist_dqn_tpu_torch.telemetry import watchdog as tm_watchdog
    from dist_dqn_tpu_torch.utils.checkpoint import (restore_pytree,
                                                     save_pytree)

    state = {"w": torch.arange(4, dtype=torch.float32)}
    path = str(tmp_path / "emergency_learner")
    tm_watchdog.register_emergency_hook(
        "test.save", lambda: save_pytree(path, {"learner": state}))
    tm_watchdog.register_emergency_hook(
        "test.wedge", lambda: time.sleep(60))
    logs = []
    try:
        t0 = time.monotonic()
        tm_watchdog.run_emergency_hooks(timeout_s=1.5, log_fn=logs.append)
        assert time.monotonic() - t0 < 30   # bounded, not 60s
    finally:
        tm_watchdog.unregister_emergency_hook("test.save")
        tm_watchdog.unregister_emergency_hook("test.wedge")
    example = {"learner": {"w": torch.zeros(4)}}
    restored = restore_pytree(path, example)
    torch.testing.assert_close(restored["learner"]["w"], state["w"])
    outcome = {p["emergency_hook"]: p["completed"]
               for p in (json.loads(s) for s in logs)}
    assert outcome == {"test.save": True, "test.wedge": False}


# ---------------------------------------------------------------------------
# The device draw seam (port-only: JAX has no test of it)
# ---------------------------------------------------------------------------

def test_device_sample_exception_leaves_pending_writes_intact():
    """``replay.device_sample``: an injected exception raises before the
    plane's pending writes flush and before any draw; the next draw
    flushes them, recovers the trip, and equals the draw of a plane that
    was never faulted, at the same uniforms. A stall only delays it."""
    from dist_dqn_tpu_torch.replay.host import DevicePrioritySampler

    rng = np.random.default_rng(3)
    pri = rng.random(4096) + 0.05

    def plane():
        s = DevicePrioritySampler(4096, lanes=16, device="cpu")
        s.set(np.arange(4096), pri)
        s.sample_at(np.full(4, 0.5, np.float32), 4096)   # flushed
        s.set(np.arange(0, 4096, 7), pri[::7] * 3.0)     # pending
        return s

    u = ((np.arange(64) + rng.random(64)) / 64).astype(np.float32)
    want = plane().sample_at(u, 4096)
    faulted = plane()
    pending = [a.copy() for a in faulted._pending_idx]
    plane_before = faulted.plane.clone()
    plan = chaos.FaultPlan(seed=4, events=(
        chaos.FaultEvent("replay.device_sample", "exception", at_hit=1),
        chaos.FaultEvent("replay.device_sample", "stall", at_hit=3,
                         args={"delay_s": 0.01})))
    with chaos.installed(plan) as inj:
        with pytest.raises(chaos.ChaosInjectedError,
                           match="replay.device_sample"):
            faulted.dispatch_at(u)
        # Nothing flushed, nothing drawn: the writes are still pending.
        assert [a.tolist() for a in faulted._pending_idx] == \
            [a.tolist() for a in pending]
        assert torch.equal(faulted.plane, plane_before)
        assert faulted.draw_dispatches == 1
        assert inj.open_trips() == ["replay.device_sample"]
        got = faulted.sample_at(u, 4096)
        assert inj.open_trips() == []
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        again = faulted.sample_at(u, 4096)            # the stall
        np.testing.assert_array_equal(again[0], want[0])
        assert inj.open_trips() == []
        assert [(e["fault"], e["hit"]) for e in inj.injected] == [
            ("exception", 1), ("stall", 3)]


# ---------------------------------------------------------------------------
# Serving dispatch chaos + the seeded whole-loop smoke
# ---------------------------------------------------------------------------

def test_serving_dispatch_injected_failure_is_structured(tmp_path):
    """An injected dispatch exception reaches each rider as a
    structured error (the server maps it to a 500, never a connection
    reset), and the NEXT dispatch completes — recovery proven."""
    from dist_dqn_tpu_torch.agents.dqn import make_learner
    from dist_dqn_tpu_torch.config import CONFIGS
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.serving import build_server
    from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer

    cfg = CONFIGS["cartpole"]
    env = make_env(cfg.env_name, device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu", seed=0)
    ckpt = TrainCheckpointer(str(tmp_path), save_every_frames=1)
    ckpt.save(10, make_learner(cfg.learner, net)[0](net))
    ckpt.close()

    plan = chaos.FaultPlan(seed=12, events=(
        chaos.FaultEvent("serving.dispatch", "exception", at_hit=2),))
    srv = build_server(cfg, {"default": str(tmp_path)}, max_rows=8,
                       max_wait_ms=1.0, queue_limit=16,
                       poll_interval_s=3600.0, log_fn=lambda *_: None,
                       device="cpu")
    try:
        obs = np.zeros((2, 4), np.float32)
        with chaos.installed(plan) as inj:
            first = srv.batcher.submit(obs, greedy=True)
            assert first.actions.shape == (2,)
            with pytest.raises(chaos.ChaosInjectedError,
                               match="serving.dispatch"):
                srv.batcher.submit(obs, greedy=True)
            again = srv.batcher.submit(obs, greedy=True)
            assert again.actions.shape == (2,)
            assert inj.open_trips() == []   # recovery observed
    finally:
        srv.close()


def _smoke_plan():
    return chaos.FaultPlan(seed=8, events=(
        chaos.FaultEvent("evac.drain", "stall", at_hit=2,
                         args={"delay_s": 0.05}),
        chaos.FaultEvent("prefetch.sample", "stall", at_hit=3,
                         args={"delay_s": 0.05}),
        chaos.FaultEvent("checkpoint.save", "crash_before_stamp",
                         at_hit=1),
        chaos.FaultEvent("latest.write", "torn", at_hit=2),
    ))


def test_seeded_chaos_smoke_replays_identically(tmp_path):
    """The seeded chaos smoke: one plan covering four seams —
    pipeline-worker stalls on both background threads, a
    commit-without-stamp checkpoint crash and a torn LATEST pointer —
    driven through two identical real host-replay runs. Invariants: both
    runs complete training to target, inject the SAME (seam, fault, hit)
    sequence (replayability), count every injection in the registry, and
    end with every trip recovered."""
    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay
    from dist_dqn_tpu_torch.telemetry.registry import Registry

    cfg = host_replay_cfg()
    plan = _smoke_plan()

    def one_run(tag):
        reg = Registry()
        with chaos.installed(plan, registry=reg) as inj:
            out = run_host_replay(
                cfg, total_env_steps=3200, chunk_iters=50,
                log_fn=_quiet, checkpoint_dir=str(tmp_path / tag),
                save_every_frames=800, device="cpu")
            # Injection evidence, ordered per seam (the cross-seam
            # interleaving is thread-timing; the per-seam dataflow
            # positions are the deterministic claim).
            injected = sorted((e["seam"], e["fault"], e["hit"])
                              for e in inj.injected)
            open_trips = inj.open_trips()
        counted = sorted(
            (c.labels["seam"], c.labels["fault"], int(c.value))
            for c in reg.collect().get("dqn_chaos_injected_total", []))
        return out, injected, open_trips, counted

    out1, injected1, open1, counted1 = one_run("a")
    out2, injected2, open2, counted2 = one_run("b")

    # Survival: training completed to target under fire, both times.
    assert out1["env_steps"] >= 3200 and out2["env_steps"] >= 3200
    assert out1["grad_steps"] == out2["grad_steps"] > 0
    # Stalls never change WHAT is computed, only when.
    assert out1["param_checksum"] == out2["param_checksum"]
    # Replayability: same plan, same injection sequence.
    assert injected1 == injected2 == sorted([
        ("checkpoint.save", "crash_before_stamp", 1),
        ("evac.drain", "stall", 2),
        ("latest.write", "torn", 2),
        ("prefetch.sample", "stall", 3),
    ])
    # Every injection recovered and was counted, per {seam, fault}.
    assert open1 == open2 == []
    assert counted1 == counted2 == sorted([
        ("checkpoint.save", "crash_before_stamp", 1),
        ("evac.drain", "stall", 1),
        ("latest.write", "torn", 1),
        ("prefetch.sample", "stall", 1),
    ])


# ---------------------------------------------------------------------------
# Arming: every entry point reads DQN_CHAOS_PLAN
# ---------------------------------------------------------------------------

def test_train_cli_arms_the_plan_and_annotates_the_manifest(tmp_path):
    """The train CLI arms ``DQN_CHAOS_PLAN`` after its manifest line: a
    host-replay run killed by the plan's chunk crash exits with the
    injected error, logs the injection, and its exit snapshot counts it
    in ``dqn_chaos_injected_total``."""
    plan = chaos.FaultPlan(seed=5, events=(
        chaos.FaultEvent("host_replay.chunk", "crash", at_hit=2),))
    env = {**os.environ, chaos.CHAOS_PLAN_ENV: plan.to_json()}
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "dist_dqn_tpu_torch.train", "--config",
         "cartpole", "--runtime", "host-replay", "--device", "cpu",
         "--total-env-steps", "1600", "--chunk-iters", "50",
         "--set", "network.mlp_features=(32,)",
         "--set", "replay.capacity=4096", "--set", "replay.min_fill=64",
         "--set", "learner.batch_size=16", "--set", "actor.num_envs=8",
         "--telemetry-snapshot", str(tmp_path / "snap.json")],
        capture_output=True, text=True, cwd=REPO, timeout=240, env=env)
    assert proc.returncode != 0
    assert "chaos: injected 'crash' at seam 'host_replay.chunk'" in \
        proc.stderr, proc.stderr[-2000:]
    injected = [json.loads(line)["chaos_injected"]
                for line in proc.stdout.splitlines()
                if line.startswith('{"chaos_injected"')]
    assert injected == [{"seam": "host_replay.chunk", "fault": "crash",
                         "hit": 2, "args": {}}]
    snap = (tmp_path / "snap.json").read_text()
    assert "dqn_chaos_injected_total" in snap and "host_replay.chunk" in snap
