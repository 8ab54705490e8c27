"""The data-parallel mesh of the port (twin of
dist_dqn_tpu/parallel/mesh.py).

JAX shapes chips into a ``jax.sharding.Mesh`` with a 1-D ``dp`` learner
axis. Here the axis is a ``torch.distributed`` process group, one rank per
device: :class:`Mesh` holds the group, this rank's index and device, the
axis size and its name, and the collectives the loops and learners run
over it. Each collective is ONE flat ``all_reduce`` or ``broadcast`` per
call, whatever the number of tensors, the only two ops ``gloo`` carries
on a CUDA tensor. :meth:`Mesh.gather` and :meth:`Mesh.barrier` carry
host numbers (a loop's per-chunk columns, a checkpoint's small shared
arrays) in one all-reduce of a zero table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One ``dp`` axis over the ranks of ``group``. ``rank`` is this
    process's position on the axis and ``device`` the device it
    drives."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_name: str = "dp"

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.size}

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def rows(self, local_rows: int) -> slice:
        """This rank's block of a global batch of ``local_rows * size``
        rows: rank r holds rows ``[r * local_rows, (r + 1) * local_rows)``,
        the block a ``P(axis)`` spec gives device r."""
        return slice(self.rank * local_rows, (self.rank + 1) * local_rows)

    def psum(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Sums across ranks, one flat ``all_reduce`` per dtype."""
        return _flat_collective(tensors, lambda flat: dist.all_reduce(
            flat, group=self.group))

    def pmean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Means across ranks: the sum, then a division by the size (JAX's
        ``pmean``); every rank gets the same bits."""
        return [t / self.size for t in self.psum(tensors)]

    def pmax(self, tensor: torch.Tensor) -> torch.Tensor:
        """Elementwise max across ranks."""
        out = tensor.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def gather(self, values) -> np.ndarray:
        """Every rank's ``values`` (host numbers, any fixed shape) as one
        float64 ``[size, *shape]`` array on every rank, in one all-reduce:
        each rank writes its row into a zero table, and adding zeros is
        exact. Under ``gloo`` the table stays on the host."""
        local = np.asarray(values, np.float64)
        dev = (torch.device("cpu") if self.backend == "gloo"
               else self.device)
        table = torch.zeros((self.size,) + local.shape,
                            dtype=torch.float64, device=dev)
        table[self.rank] = torch.from_numpy(local).to(dev)
        dist.all_reduce(table, group=self.group)
        return table.cpu().numpy()

    def barrier(self) -> None:
        """Return once every rank has reached this call."""
        self.gather(np.zeros(1))

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0
                   ) -> None:
        """Overwrite ``tensors`` in place with rank ``src``'s copies."""
        out = _flat_collective(tensors, lambda flat: dist.broadcast(
            flat, src=src, group=self.group))
        for t, o in zip(tensors, out):
            t.copy_(o)


def _flat_collective(tensors: Sequence[torch.Tensor], op
                     ) -> List[torch.Tensor]:
    """Apply the in-place collective ``op`` to the tensors packed into one
    flat buffer per dtype; returns new tensors of the inputs' shapes."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        op(flat)
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              device=None) -> Mesh:
    """The mesh of this rank over the initialized process group (every
    rank). ``axis_sizes=None`` puts every rank on the one axis. Only a
    single ``dp`` axis is supported, since nothing in the JAX package
    builds another layout; ``device`` defaults to the current card under
    NCCL and the CPU under ``gloo``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.initialize)")
    group = dist.group.WORLD
    size = dist.get_world_size(group)
    if axis_sizes is None:
        axis_sizes = [size] + [1] * (len(axis_names) - 1)
    if tuple(axis_names) != ("dp",) or list(axis_sizes) != [size]:
        raise ValueError(
            f"the port's mesh is one 'dp' axis over all {size} ranks; got "
            f"axis names {tuple(axis_names)} with sizes {list(axis_sizes)}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    return Mesh(group=group, rank=dist.get_rank(group), size=size,
                device=torch.device(device), axis_name=axis_names[0])
