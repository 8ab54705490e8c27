"""Checkpoint/resume of the port (twin of dist_dqn_tpu/utils/checkpoint.py).

The recovery point is the learner: both nets, Adam's count and moments,
the step counter and the learner's generator (a *learner*-kind
checkpoint). Replay refills from live experience on resume, so a resumed
run is statistically equivalent to an uninterrupted one, not bit-equal.
``train(..., checkpoint_replay=True)`` / ``--checkpoint-replay`` saves
the whole fused carry instead (a *carry*-kind checkpoint: the ring with
its host cursors, the env states, the actor's LSTM carry and every
generator), and a run resumed from it is bit-equal to one that never
stopped.

Files are ``torch.save`` / ``torch.load(weights_only=True)``, not orbax.
One step is a directory ``<dir>/<frames>/`` holding ``state.pt``; it is
written under a dot-named temporary name and renamed into place, so a
half-written step is never a digit-named directory. Saves are
synchronous.

What is saved is the plain tree :func:`state_tree` makes of the live
objects (dataclasses, NamedTuples, lists and tuples walked; tensors as
they are; ``nn.Module`` s as their ``state_dict``; generators as their
``get_state()``; host ints as ints). :func:`load_state_tree` reads such
a tree back into a live template of the same structure, the object
``init(seed)`` builds, checking every tensor's shape and dtype.

A population run's steps hold the [M]-stacked tree, and its directory a
``POPULATION`` width marker (:func:`record_population_size`): a resume at
another width is refused with the cause, and ``restore_params(...,
member=k)`` reads one member's params into a solo net (evaluate.py
``--member``).
"""
from __future__ import annotations

import dataclasses
import errno
import json
import os
import shutil
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dist_dqn_tpu_torch.population import extract_member

_STATE_FILE = "state.pt"
_LATEST_FILE = "LATEST"
_KIND_FILE = "CHECKPOINT_KIND"
_POPULATION_FILE = "POPULATION"


# --------------------------------------------------------------------------
# The state walk.
# --------------------------------------------------------------------------

class CheckpointStructureError(ValueError):
    """A saved tree does not fit the live template (a config drift)."""


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def state_tree(obj) -> Any:
    """The plain, ``torch.save``-able tree of a live object: dataclasses
    and NamedTuples become dicts by field, lists and tuples lists, an
    ``nn.Module`` its ``state_dict``, a ``torch.Generator`` its state
    tensor; tensors (detached) and host scalars stay as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, nn.Module):
        return dict(obj.state_dict())
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: state_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if _is_namedtuple(obj):
        return {name: state_tree(getattr(obj, name)) for name in obj._fields}
    if isinstance(obj, (list, tuple)):
        return [state_tree(x) for x in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint an object of type {type(obj)!r}")


def _check_tensor(path: str, template: torch.Tensor, saved) -> None:
    if not isinstance(saved, torch.Tensor):
        raise CheckpointStructureError(
            f"{path}: saved {type(saved).__name__}, the live state holds a "
            "tensor")
    if saved.dtype != template.dtype or saved.shape != template.shape:
        raise CheckpointStructureError(
            f"{path}: saved {saved.dtype} {tuple(saved.shape)}, the live "
            f"state holds {template.dtype} {tuple(template.shape)}")


def check_state_dict(path: str, module: nn.Module, saved,
                     stack: Tuple[int, ...] = ()) -> None:
    """Raise :class:`CheckpointStructureError` unless ``saved`` has exactly
    ``module``'s state-dict names, shapes and dtypes (each shape behind
    ``stack``, the member axis of a population's stacked params)."""
    if not isinstance(saved, dict):
        raise CheckpointStructureError(
            f"{path}: saved {type(saved).__name__}, the live state holds a "
            "module")
    live = {k: (v.dtype, stack + tuple(v.shape))
            for k, v in module.state_dict().items()}
    disk = {k: (v.dtype, tuple(v.shape)) for k, v in saved.items()
            if isinstance(v, torch.Tensor)}
    if live != disk or len(disk) != len(saved):
        only_live = sorted(set(live) - set(disk))[:3]
        only_disk = sorted(set(saved) - set(live))[:3]
        drift = sorted(k for k in set(live) & set(disk)
                       if live[k] != disk[k])[:3]
        raise CheckpointStructureError(
            f"{path}: param leaves only in the live net: {only_live}; only "
            f"in the checkpoint: {only_disk}; shape/dtype drift: {drift}")


def load_state_tree(template, tree, path: str = "state"):
    """Read the saved ``tree`` back into ``template``, the live object of
    the same structure, and return it. Tensors are copied into the
    template's tensors (on the template's device), modules load their
    state dicts, generators their states; dataclasses are updated field by
    field and NamedTuples rebuilt. Raises :class:`CheckpointStructureError`
    where the structure, a shape or a dtype differs."""
    return _load(template, tree, path, set())


def _load(template, tree, path: str, written: set):
    if isinstance(template, torch.Tensor):
        _check_tensor(path, template, tree)
        storage = template.untyped_storage().data_ptr()
        if storage in written:
            # The template shares this storage with a tensor already
            # loaded (an env's obs is its state's frame stack after a
            # reset): give this leaf its own copy.
            return tree.to(template.device, copy=True)
        written.add(storage)
        with torch.no_grad():
            template.copy_(tree)
        return template
    if isinstance(template, nn.Module):
        check_state_dict(path, template, tree)
        template.load_state_dict(tree)
        return template
    if isinstance(template, torch.Generator):
        if not isinstance(tree, torch.Tensor) or tree.dtype != torch.uint8:
            raise CheckpointStructureError(
                f"{path}: no generator state saved")
        template.set_state(tree)
        return template
    if dataclasses.is_dataclass(template) or _is_namedtuple(template):
        names = ([f.name for f in dataclasses.fields(template)]
                 if dataclasses.is_dataclass(template) else
                 list(template._fields))
        if not isinstance(tree, dict) or set(tree) != set(names):
            got = sorted(tree) if isinstance(tree, dict) else \
                type(tree).__name__
            raise CheckpointStructureError(
                f"{path}: saved fields {got}, the live "
                f"{type(template).__name__} has {names}")
        values = {n: _load(getattr(template, n), tree[n], f"{path}.{n}",
                           written) for n in names}
        if _is_namedtuple(template):
            return type(template)(**values)
        for n, v in values.items():
            setattr(template, n, v)
        return template
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, list) or len(tree) != len(template):
            raise CheckpointStructureError(
                f"{path}: saved {type(tree).__name__} of "
                f"{len(tree) if isinstance(tree, list) else '?'} items, the "
                f"live state holds {len(template)}")
        return type(template)(_load(t, s, f"{path}[{i}]", written)
                              for i, (t, s) in enumerate(zip(template, tree)))
    if type(tree) is not type(template):
        raise CheckpointStructureError(
            f"{path}: saved {tree!r}, the live state holds {template!r}")
    return tree


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _atomic_torch_save(tree, path: str) -> int:
    """``torch.save`` to ``path`` through a temporary name; returns the
    bytes written."""
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(tree, tmp)
    size = os.path.getsize(tmp)
    os.replace(tmp, path)
    return size


# --------------------------------------------------------------------------
# The checkpointer.
# --------------------------------------------------------------------------

_DRIFT = ("Rebuild with the same --config and --set overrides used at save "
          "time.")


@dataclasses.dataclass
class TrainCheckpointer:
    """Periodic checkpoints with retention + resume.

    Usage:
      ckpt = TrainCheckpointer(dir, save_every_frames=100_000)
      start = ckpt.restore_latest(learner)   # (frames, learner) or None
      ...
      ckpt.maybe_save(frames, learner)       # inside the training loop

    ``last_save`` / ``last_restore`` hold the seconds and bytes of the
    newest save and restore ({"step", "seconds", "bytes"}).
    """

    directory: str
    save_every_frames: int = 100_000
    max_to_keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._next_save = 0
        self.last_save: Optional[dict] = None
        self.last_restore: Optional[dict] = None

    def maybe_save(self, frames: int, tree) -> bool:
        """Save when the frame cursor crosses the next save boundary."""
        if frames < self._next_save:
            return False
        self.save(frames, tree)
        self._next_save = frames + self.save_every_frames
        return True

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, frames: int, tree) -> bool:
        """Write step ``frames`` and stamp the ``LATEST`` pointer after it
        landed; drop the oldest steps beyond ``max_to_keep``. A step at or
        below the newest retained one is not written (returns False), as
        orbax's manager skips it."""
        steps = self.all_steps()
        if steps and steps[-1] >= frames:
            return False
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f".tmp-{int(frames)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        size = _atomic_torch_save(state_tree(tree),
                                  os.path.join(tmp, _STATE_FILE))
        os.replace(tmp, self._step_dir(frames))
        write_latest_pointer(self.directory, frames,
                             param_checksum=_pointer_checksum(tree))
        for old in self.all_steps()[:-self.max_to_keep]:
            self.delete(old)
        self.last_save = {"step": int(frames),
                          "seconds": time.perf_counter() - t0, "bytes": size}
        return True

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def all_steps(self) -> Tuple[int, ...]:
        """Retained checkpoint steps (frame cursors), oldest first."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return ()
        return tuple(sorted(int(e) for e in entries if e.isdigit() and
                            os.path.isdir(os.path.join(self.directory, e))))

    def delete(self, step: int) -> None:
        """Remove one retained step."""
        shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        """Newest complete checkpoint step: the max of the ``LATEST``
        pointer (when its step directory still exists) and the listing, so
        a pointer left stale by a crash between a save and its stamp never
        hides a newer step."""
        steps = list(self.all_steps()[-1:])
        ptr = read_latest_pointer(self.directory)
        if ptr is not None and os.path.isdir(self._step_dir(ptr["step"])):
            steps.append(int(ptr["step"]))
        return max(steps) if steps else None

    def _read(self, step: int):
        path = os.path.join(self._step_dir(step), _STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"checkpoint step {step} not found under {self.directory!r}")
        return _torch_load(path), os.path.getsize(path)

    def restore_latest(self, example, step: Optional[int] = None):
        """Restore the newest checkpoint (or a retained ``step`` of
        ``all_steps()``) into the live ``example`` as (frames, tree), or
        None when there is none. The save schedule advances only on the
        latest-resume path: an explicitly requested old step (the eval
        surfaces walk ``all_steps()``) must not regress it and re-save
        over newer retained steps."""
        advance_schedule = step is None
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        t0 = time.perf_counter()
        tree, size = self._read(step)
        try:
            restored = load_state_tree(example, tree)
        except CheckpointStructureError as e:
            raise ValueError(
                "checkpoint does not match the current config's learner "
                "structure — it was saved with a different network/"
                f"optimizer architecture. {_DRIFT}\n\nOriginal "
                f"error:\n{e}") from e
        if advance_schedule:
            self._next_save = step + self.save_every_frames
        self.last_restore = {"step": int(step),
                             "seconds": time.perf_counter() - t0,
                             "bytes": size}
        return int(step), restored

    def restore_params(self, example_params: nn.Module,
                       step: Optional[int] = None,
                       prefix: Tuple[str, ...] = (),
                       member: Optional[int] = None):
        """Restore only the policy parameters of a checkpoint into the
        live network ``example_params`` as (frames, net), or None.

        The deploy surfaces need the params to match the live network, and
        nothing else: the optimizer (an lr schedule) never constrains an
        eval, and a carry-kind checkpoint (``prefix=("learner",)``) needs
        no ring-sized template (the file is memory-mapped, so only the
        params are read). Names, shapes and dtypes are compared before
        anything is loaded; a drift in either direction raises the
        config-drift ``ValueError``. Read-only: never advances the save
        schedule.

        A population directory holds [M]-stacked params: ``member=k``
        checks them against the solo ``example_params`` behind the member
        axis and loads member k's slice. A member asked of a solo
        directory, a member out of range and a member-less restore of a
        stacked directory are refused with the JAX package's texts."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        pop_size = read_population_size(self.directory)
        if member is not None:
            if pop_size is None:
                raise ValueError(
                    f"member={member} requested but {self.directory!r} "
                    "is not a population checkpoint (no POPULATION "
                    "width marker) — drop the member selector")
            if not 0 <= member < pop_size:
                raise ValueError(
                    f"member={member} is out of range for a population-"
                    f"{pop_size} checkpoint (members are 0-based)")
        elif pop_size is not None:
            raise ValueError(
                f"{self.directory!r} holds a population-{pop_size} "
                "[M]-stacked tree — pass member=k (evaluate.py "
                "--member k) to extract one policy")
        tree, _ = self._read(step)
        sub = tree
        try:
            for key in prefix + ("net",):
                sub = sub[key]
        except (KeyError, TypeError) as e:
            raise ValueError(
                f"checkpoint at step {step} has no "
                f"{'/'.join(prefix + ('net',))} subtree — wrong checkpoint "
                "kind or directory") from e
        stack = (pop_size,) if member is not None else ()
        try:
            check_state_dict("params", example_params, sub, stack)
        except CheckpointStructureError as e:
            raise ValueError(
                "checkpoint parameters do not match the current config's "
                "network structure — it was saved with a different network "
                f"architecture. {_DRIFT}\n{e}") from e
        if member is not None:
            sub = extract_member(sub, member)
        example_params.load_state_dict(sub)
        return int(step), example_params

    def close(self) -> None:
        """Nothing is held open between calls."""


class CheckpointMissingError(FileNotFoundError):
    """The requested checkpoint (dir or step) is absent. A distinct type
    so bounded-retry launchers (evaluate --wait-for-checkpoint) and
    --all-steps walks catch exactly this condition, never an unrelated
    FileNotFoundError from the work itself."""


def wait_for_checkpoint(fn, wait_s: float, stop=None):
    """Run ``fn()``, retrying :class:`CheckpointMissingError` for up to
    ``wait_s`` seconds (an eval launched beside a training run that has
    not saved yet). A 0 budget is one attempt; any other error is raised
    on the first attempt. ``stop`` (a ``threading.Event``) ends the wait
    early by re-raising the pending CheckpointMissingError."""
    deadline = time.monotonic() + max(wait_s, 0.0)
    while True:
        try:
            return fn()
        except CheckpointMissingError as e:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or (stop is not None and stop.is_set()):
                raise
            print(f"# waiting for checkpoint ({e}); "
                  f"{remaining:.0f}s left", flush=True)
            nap = min(2.0, remaining)
            if stop is not None:
                if stop.wait(nap):
                    raise
            else:
                time.sleep(nap)


def _pointer_checksum(tree) -> Optional[float]:
    """Params digest for the ``LATEST`` pointer: the float64 sum of the
    policy network's parameters, or None when the saved object has no
    recognizable network. Carry-kind trees digest their learner's net —
    never the ring."""
    obj = getattr(tree, "learner", tree)
    net = getattr(obj, "net", obj)
    if not isinstance(net, nn.Module):
        return None
    return float(sum(torch.sum(v.detach().to("cpu", torch.float64)).item()
                     for v in net.state_dict().values()
                     if v.is_floating_point()))


def write_latest_pointer(directory: str, step: int,
                         param_checksum=None) -> None:
    """Atomically (tmp + rename) stamp ``<directory>/LATEST`` with the
    newest complete checkpoint step and its param checksum, so readers
    address it without globbing step dirs. The manifest hash the JAX
    package stamps beside them is null here (the port has no run
    manifest yet)."""
    payload = {"step": int(step), "param_checksum": param_checksum,
               "manifest_hash": None, "saved_unix": time.time()}
    path = os.path.join(directory, _LATEST_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, sort_keys=True)
    os.replace(tmp, path)


def read_latest_pointer(directory: str):
    """The parsed ``LATEST`` pointer dict, or None (absent, or torn, in
    which case readers fall back to the directory listing)."""
    try:
        with open(os.path.join(directory, _LATEST_FILE)) as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) or not isinstance(payload.get("step"),
                                                       int):
        return None
    return payload


def checkpoint_present(directory: str) -> bool:
    """Cheap committed-checkpoint probe: the ``LATEST`` pointer or any
    digit-named step dir (a step being written has a dot-named temporary
    name). Creates nothing."""
    if not os.path.isdir(directory):
        return False
    if read_latest_pointer(directory) is not None:
        return True
    try:
        entries = os.listdir(directory)
    except OSError:
        return False
    return any(e.isdigit() and os.path.isdir(os.path.join(directory, e))
               for e in entries)


def record_checkpoint_kind(directory: str, kind: str) -> None:
    """Stamp what a checkpoint directory's steps hold: ``learner`` (the
    default recovery point) or ``carry`` (--checkpoint-replay's whole
    fused carry). A run that would write the other kind into the
    directory raises with the actual cause instead of failing as a
    structure mismatch."""
    existing = read_checkpoint_kind(directory)
    if existing is not None and existing != kind:
        raise ValueError(
            f"checkpoint directory {directory!r} holds {existing!r} "
            f"checkpoints but this run would write {kind!r} — the "
            "--checkpoint-replay flag differs from the run that created "
            "the directory. Resume with the same flag, or use a fresh "
            "--checkpoint-dir.")
    if existing is None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, _KIND_FILE), "w") as fh:
            fh.write(kind)


def read_checkpoint_kind(directory: str):
    """The recorded kind, or None."""
    try:
        with open(os.path.join(directory, _KIND_FILE)) as fh:
            return fh.read().strip() or None
    except OSError:
        return None


def record_population_size(directory: str, size: int) -> None:
    """Stamp a population run's member-axis width M. The stacked tree's
    leading [M] axis is checkpoint structure: resuming a population-M'
    directory at another width would fail as an opaque shape mismatch, so
    the width is pinned up front and a mismatch says the actual cause."""
    existing = read_population_size(directory)
    if existing is not None and existing != size:
        raise ValueError(
            f"checkpoint directory {directory!r} holds a population-"
            f"{existing} stacked tree but this run trains --population "
            f"{size} — the member axis is part of the checkpoint "
            "structure. Resume with the same --population, use a fresh "
            "--checkpoint-dir, or extract single members with "
            "restore_params(member=k) / evaluate.py --member.")
    if existing is None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, _POPULATION_FILE), "w") as fh:
            fh.write(str(int(size)))


def read_population_size(directory: str):
    """The recorded member width M, or None (a solo directory)."""
    try:
        with open(os.path.join(directory, _POPULATION_FILE)) as fh:
            text = fh.read().strip()
    except OSError:
        return None
    return int(text) if text else None


def list_checkpoint_steps(directory: str) -> Tuple[int, ...]:
    """Retained checkpoint steps under ``directory``, oldest first. A
    missing directory raises instead of being created."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(
            f"no checkpoint found under {directory!r}")
    return TrainCheckpointer(directory).all_steps()


def atomic_savez(path: str, **arrays) -> None:
    """np.savez to ``path`` atomically (tmp + rename): a crash mid-write
    leaves the previous file, never a torn npz."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def save_pytree(path: str, tree) -> None:
    """One-shot save of a live object's :func:`state_tree` (the
    --export-params deploy artifact), atomically."""
    parent = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(parent):
        raise FileNotFoundError(errno.ENOENT, "no such directory", parent)
    _atomic_torch_save(state_tree(tree), path)


def restore_pytree(path: str, example):
    """Load what :func:`save_pytree` wrote into the live ``example``."""
    return load_state_tree(example, _torch_load(path))
