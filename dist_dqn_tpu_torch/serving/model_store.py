"""ModelStore of the port (twin of ``dist_dqn_tpu/serving/model_store.py``):
resident policy params with checkpoint hot-reload.

One entry per tenant policy id. Each entry pins a training run's
checkpoint directory (utils/checkpoint.py) and holds the newest restored
params as an immutable :class:`PolicySnapshot`. A watcher thread polls
each directory's atomic ``LATEST`` pointer (written by
``TrainCheckpointer.save`` after the step landed), restores new steps OFF
the serving path, and swaps the snapshot reference under the store lock.
The act path only ever does ``store.snapshot(policy_id)`` — one lock
acquire, one reference read — so a reload never blocks acting on restore
I/O, and because the batcher resolves one snapshot per dispatched batch,
a swap can never produce a mixed-version batch.

Restores go through ``TrainCheckpointer.restore_params`` — the same
params-only restore evaluate.py deploys with, under the same
``params_prefix`` rule, so optimizer structure never constrains serving
and carry-kind and host_loop-kind run dirs serve without a ring-sized
template.

Where the port differs from JAX: a JAX snapshot's params are an
immutable pytree, fresh on every restore, while ``restore_params`` loads
IN PLACE into the module it is given. So every snapshot owns its own
module, a deep copy of the ``example_params`` template on the serving
device; a restore loads into that new module only, and the template and
every resident snapshot are never written. On the card the copy and the
load run on a side stream of the watcher thread, which is synchronised
before the reference swap, so the dispatch thread never sees a
half-loaded module. An old snapshot is dropped only after the dispatch
thread's last use of it, which ends in the ``.cpu()`` fence of its batch.

The ``serving.reload`` chaos seam fires at the top of every restore (hit
1 is the startup restore): "slow_reload" holds the restore mid-flight on
the host, before the restore's device-work block, while the act path keeps
serving the resident snapshot; "fail" exercises the watcher's
keep-resident-and-retry contract. The next completed swap marks it
recovered.
"""
from __future__ import annotations

import contextlib
import copy
import os
import threading
from typing import Dict, List, Optional

import torch

from dist_dqn_tpu_torch import chaos
from dist_dqn_tpu_torch.serving.types import PolicySnapshot, UnknownPolicyError
from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry import devtime, get_registry
from dist_dqn_tpu_torch.utils.checkpoint import (CheckpointMissingError,
                                                 TrainCheckpointer,
                                                 params_prefix,
                                                 read_latest_pointer)


class _PolicyEntry:
    """One policy id's checkpoint binding + current snapshot."""

    def __init__(self, policy_id: str, checkpoint_dir: str, ckpt, prefix,
                 epsilon: float, member: Optional[int] = None):
        self.policy_id = policy_id
        self.checkpoint_dir = checkpoint_dir
        self.ckpt = ckpt                      # TrainCheckpointer
        self.prefix = prefix
        self.epsilon = epsilon
        self.member = member                  # population member slice
        self.snapshot: Optional[PolicySnapshot] = None


class ModelStore:
    """Resident policies + the hot-reload watcher.

    ``example_params`` is the serving network, an ``nn.Module`` on the
    serving device: the restore template every policy's checkpoints must
    match (all tenants share one network architecture and one act
    program). It is copied for each snapshot and never served or written
    itself.
    """

    def __init__(self, example_params, poll_interval_s: float = 10.0,
                 log_fn=print):
        self.example_params = example_params
        self.poll_interval_s = float(poll_interval_s)
        self.log = log_fn
        self._entries: Dict[str, _PolicyEntry] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None   # the restores' side stream on the card
        reg = get_registry()
        self._tm_reloads: Dict[str, object] = {}
        self._tm_version: Dict[str, object] = {}
        self._reg = reg

    # -- registration -------------------------------------------------------
    def add_policy(self, policy_id: str, checkpoint_dir: str,
                   epsilon: float = 0.0,
                   member: Optional[int] = None) -> PolicySnapshot:
        """Register a tenant and BLOCKING-restore its newest checkpoint
        (startup path — the serving loop is not live yet). Raises the
        distinct CheckpointMissingError when the directory is absent or
        holds no complete checkpoint yet — the retryable
        launched-beside-training shape the CLI's --wait-for-checkpoint
        waits on (unrelated startup failures stay loud).

        ``member`` serves one policy out of a --population run's
        [M]-stacked checkpoint: every restore — startup and hot-reload
        alike — extracts member k's slice, so M tenants can bind M members
        of the same run directory and hot-reload independently off one
        stacked save."""
        if not os.path.isdir(checkpoint_dir):
            raise CheckpointMissingError(
                f"policy {policy_id!r}: no checkpoint found under "
                f"{checkpoint_dir!r}")
        ckpt = TrainCheckpointer(checkpoint_dir)
        entry = _PolicyEntry(policy_id, checkpoint_dir, ckpt,
                             params_prefix(checkpoint_dir), epsilon,
                             member=member)
        snap = self._restore(entry, step=None, version=1)
        if snap is None:
            raise CheckpointMissingError(
                f"policy {policy_id!r}: no checkpoint found under "
                f"{checkpoint_dir!r}")
        entry.snapshot = snap
        with self._lock:
            self._entries[policy_id] = entry
        return snap

    # -- act-path read ------------------------------------------------------
    def snapshot(self, policy_id: str) -> PolicySnapshot:
        """The policy's current immutable snapshot — one lock acquire,
        one reference read; never any I/O."""
        with self._lock:
            entry = self._entries.get(policy_id)
            if entry is None or entry.snapshot is None:
                raise UnknownPolicyError(
                    f"unknown policy {policy_id!r} (resident: "
                    f"{sorted(self._entries)})")
            return entry.snapshot

    def policies(self) -> Dict[str, Dict]:
        """{policy_id: header dict} for /v1/policies."""
        with self._lock:
            return {
                pid: {"version": e.snapshot.version,
                      "step": e.snapshot.step,
                      "epsilon": e.snapshot.epsilon,
                      "param_checksum": e.snapshot.param_checksum,
                      "checkpoint_dir": e.checkpoint_dir,
                      **({"member": e.member}
                         if e.member is not None else {})}
                for pid, e in self._entries.items()
                if e.snapshot is not None
            }

    # -- hot reload ---------------------------------------------------------
    def _newest_step(self, entry: _PolicyEntry) -> Optional[int]:
        """The directory's newest complete step, LATEST-pointer first
        (utils/checkpoint.py ``latest_step``)."""
        try:
            return entry.ckpt.latest_step()
        except Exception as e:
            self.log(f"# serving: poll of {entry.checkpoint_dir!r} "
                     f"failed ({type(e).__name__}: {e})")
            return None

    def _restore_context(self):
        """A side stream of the restoring thread on the card (created
        once), or nothing on the CPU."""
        device = next(self.example_params.parameters()).device
        if device.type != "cuda":
            return None, contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream, torch.cuda.stream(self._stream)

    def _restore(self, entry: _PolicyEntry, step: Optional[int],
                 version: int) -> Optional[PolicySnapshot]:
        """Restore ``step`` (None = newest) into a fresh snapshot with a
        module of its own. Blocking I/O — called at startup and from the
        watcher thread, NEVER from the act path."""
        # Chaos seam: slow_reload holds the restore mid-flight
        # (reload-during-load — the act path must keep serving the
        # resident snapshot, version headers must never tear); fail
        # exercises poll_once's keep-resident-and-retry contract.
        ev = chaos.fire("serving.reload")
        if ev is not None:
            if ev.fault == "fail":
                raise chaos.ChaosInjectedError("serving.reload", ev.fault)
            chaos.sleep_for(ev)
        stream, ctx = self._restore_context()
        with devtime.device_work(), ctx:
            module = copy.deepcopy(self.example_params)
            restored = entry.ckpt.restore_params(module, step=step,
                                                 prefix=entry.prefix,
                                                 member=entry.member)
            if stream is not None:
                # The copy and the load are on the card before anyone
                # can reach the new module.
                stream.synchronize()
        if restored is None:
            return None
        got_step, params = restored
        ptr = read_latest_pointer(entry.checkpoint_dir)
        # Population entries serve a member SLICE; the pointer's digest
        # covers the whole stacked tree, so it would mislabel the slice.
        checksum = (ptr.get("param_checksum")
                    if ptr and int(ptr.get("step", -1)) == got_step
                    and entry.member is None
                    else None)
        return PolicySnapshot(
            policy_id=entry.policy_id, params=params, version=version,
            step=got_step, param_checksum=checksum,
            epsilon=entry.epsilon)

    def poll_once(self) -> List[str]:
        """One watcher pass: reload every policy whose directory has a
        newer complete step than its resident snapshot. Returns the
        policy ids swapped (test surface; the watcher thread just calls
        this on its interval)."""
        with self._lock:
            entries = list(self._entries.values())
        reloaded = []
        for entry in entries:
            current = entry.snapshot
            newest = self._newest_step(entry)
            if current is None or newest is None or newest <= current.step:
                continue
            try:
                snap = self._restore(entry, step=newest,
                                     version=current.version + 1)
            except Exception as e:
                # A torn/mismatched checkpoint must not take serving
                # down — keep the resident version, log, retry next poll.
                self.log(f"# serving: hot-reload of {entry.policy_id!r} "
                         f"step {newest} failed ({type(e).__name__}: {e})"
                         "; keeping resident version")
                continue
            if snap is None:
                continue
            with self._lock:
                entry.snapshot = snap  # THE atomic swap
            chaos.mark_recovered("serving.reload")
            reloaded.append(entry.policy_id)
            self._reload_counter(entry.policy_id).inc()
            self._version_gauge(entry.policy_id).set(snap.version)
            self.log(f'{{"serving_reload": "{entry.policy_id}", '
                     f'"step": {snap.step}, "version": {snap.version}}}')
        return reloaded

    def _reload_counter(self, policy_id: str):
        c = self._tm_reloads.get(policy_id)
        if c is None:
            c = self._reg.counter(
                tmc.SERVING_RELOADS,
                "checkpoint hot-reload swaps", {"policy": policy_id})
            self._tm_reloads[policy_id] = c
        return c

    def _version_gauge(self, policy_id: str):
        g = self._tm_version.get(policy_id)
        if g is None:
            g = self._reg.gauge(
                tmc.SERVING_POLICY_VERSION,
                "resident snapshot version", {"policy": policy_id})
            self._tm_version[policy_id] = g
        return g

    # -- watcher lifecycle --------------------------------------------------
    def start(self) -> None:
        """Start the hot-reload watcher thread (idempotent)."""
        if self._thread is not None:
            return
        # Snapshot under the lock: add_policy mutates _entries under the
        # lock from whatever thread registers late tenants, and iterating
        # the live dict here would race that with "dictionary changed
        # size during iteration" — the same copy-then-walk poll_once uses.
        with self._lock:
            entries = list(self._entries.values())
        for entry in entries:
            if entry.snapshot is not None:
                self._version_gauge(entry.policy_id).set(
                    entry.snapshot.version)
        self._thread = threading.Thread(
            target=self._run, name="serving-ckpt-watcher", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # the watcher must survive any poll
                self.log(f"# serving: watcher pass failed "
                         f"({type(e).__name__}: {e})")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            self._entries.clear()
