"""The ``(data, model)`` mesh over ``torch.distributed`` (port of
``hgr_tpu/parallel/mesh.py:28-65``).

The whole package uses one 2-D logical layout of the processes:

- ``data``: the batch axis (images). Each data row takes a contiguous slice
  of a test batch, or its own class batch in training;
- ``model``: the class axis. The depth-sorted ``[N_pad, D]`` class bank
  shards here into contiguous row ranges, and in training the ranks of one
  data row split that row's encoder passes.

Ranks lie row-major, as ``np.asarray(devices).reshape(data, model)`` lays
JAX's devices out: rank r sits at ``(r // model, r % model)``. Where JAX
emits the collectives from shardings, here each rank holds its own piece
(``bank_shard``, ``batch_shard``) and the two process groups that the
collectives run over (``parallel/collectives.py``): the data group, the
ranks of one model column (the ``psum`` over ``data``), and the model group,
the ranks of one data row (the gathers over ``model``).

Without an initialised process group the mesh is 1 x 1 and its groups are
``None``: every collective is then the identity, and nothing is sent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh and its two process groups."""

    data: int
    model: int
    rank: int
    data_group: Optional[dist.ProcessGroup]    # this model column's ranks (size data)
    model_group: Optional[dist.ProcessGroup]   # this data row's ranks (size model)

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def bank_shard(self, bank_sorted: torch.Tensor) -> torch.Tensor:
        """This rank's rows ``[m N/M, (m+1) N/M)`` of the depth-sorted bank
        (``P(MODEL, None)``); ``N_pad`` must divide by ``model``."""
        n = bank_sorted.shape[0]
        if n % self.model:
            raise ValueError(f"bank rows {n} do not divide over model axis {self.model}")
        return bank_sorted[part_rows(n, self.model, self.model_index)]

    def batch_shard(self, x):
        """This rank's rows ``[d B/D, (d+1) B/D)`` of a batch (``P(DATA)``);
        ``B`` must divide by ``data``."""
        b = x.shape[0]
        if b % self.data:
            raise ValueError(f"batch {b} does not divide over data axis {self.data}")
        return x[part_rows(b, self.data, self.data_index)]


def part_rows(n: int, parts: int, index: int) -> slice:
    """Rows ``[index n/parts, (index+1) n/parts)``: part ``index`` of ``n``
    rows cut into ``parts`` contiguous parts of ``n // parts`` rows."""
    per = n // parts
    return slice(index * per, (index + 1) * per)


def make_mesh(data: int = -1, model: int = 1, world_size: Optional[int] = None) -> Mesh:
    """The global ``(data, model)`` mesh over the initialised process group
    (or a world of ``world_size``); ``data=-1`` takes all the ranks left
    after ``model``. Every rank must call it, with the same arguments: it
    creates the process groups of every row and column, in one order."""
    initialised = dist.is_available() and dist.is_initialized()
    n = world_size if world_size is not None else (dist.get_world_size() if initialised else 1)
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} must divide device count {n}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if not initialised:
        return Mesh(data, model, 0, None, None)
    rank = dist.get_rank()
    data_group = model_group = None
    # new_group is collective: every rank creates every group, in one order
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return Mesh(data, model, rank, data_group, model_group)
