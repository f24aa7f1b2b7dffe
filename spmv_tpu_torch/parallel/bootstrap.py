"""Process-group bootstrap and shard meshes for the multi-device layer.

Counterpart of `spmv_tpu/parallel/bootstrap.py`, rebuilt on
`torch.distributed`. A `ShardMesh` is one axis of `n_shards` shards and
the only two collectives the layer uses. It comes in two kinds:

- a LOCAL mesh holds every shard in one process on one device: plan
  arrays are stacked `(n_shards, ...)` and the collectives are tensor
  reshapes. Any shard count runs on one card, as the reference's tests
  and weak-scaling bench run their meshes on virtual CPU devices in one
  process; on one card the shards run one after another.
- a PROCESS-GROUP mesh puts one shard on each rank of the default
  process group (`n_shards == world_size`): each rank keeps its own
  `(1, ...)` row of the plan arrays, and the collectives are
  `torch.distributed`'s (NCCL on the card, gloo on the CPU). It is the
  counterpart of a multi-host job.

- `init_distributed()` joins the process group when one is configured
  (arguments, or torchrun's environment) and returns the world size;
  with nothing configured it returns 1 and creates no group.
- Each collective has a started form (`start_all_to_all`,
  `start_all_gather`) that returns a `Started` handle at once, so that
  work that does not read its result runs while it is in flight; the
  handle's `wait()` joins it and returns the result.
- `make_mesh()` builds a mesh; `put_global()` places a host-replicated
  `(n_shards, ...)` plan array onto it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spmv_tpu_torch.config import device_for


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Join (or create) the default process group; returns its size.

    Idempotent: once a group exists this returns its size. With no
    `init_method`, no world size above 1 and no torchrun environment
    (WORLD_SIZE > 1), it returns 1 without creating a group. `backend`
    defaults to 'nccl' when CUDA is available and 'gloo' otherwise.
    Under NCCL each rank takes the card LOCAL_RANK (else its rank, from
    the argument or RANK, modulo the card count) before the group is
    made, so that the communicator is made on that card."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    configured = (init_method is not None or (world_size or 1) > 1
                  or env_world > 1)
    if not configured:
        return 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (rank if rank is not None else int(os.environ.get("RANK", "0"))
                     ) % torch.cuda.device_count()
        torch.cuda.set_device(int(local))
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dist.get_world_size()


class Started:
    """A collective started on a mesh. `wait()` joins it and returns its
    result: under NCCL the current stream waits for the collective's
    stream (a stream wait, which a CUDA graph capture records as an
    edge; the host does not wait), under gloo the host waits for it. On
    a local mesh the collective is done already and `wait()` only
    returns the result."""

    def __init__(self, work, result):
        self._work = work
        self._result = result  # () -> the result, read once joined

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._result()


@dataclasses.dataclass
class ShardMesh:
    """One mesh axis of `n_shards` shards on `device`.

    `distributed` False: a local mesh, every shard in this process
    (`rank` is 0 and unused). True: one shard per rank of the default
    process group, this process holding shard `rank`. Shard-stacked
    tensors have a leading axis of `n_local` rows: n_shards on a local
    mesh, 1 on a process-group mesh."""

    axis: str
    n_shards: int
    device: torch.device
    distributed: bool = False
    rank: int = 0

    @property
    def n_local(self) -> int:
        return 1 if self.distributed else self.n_shards

    @property
    def shard_ids(self) -> range:
        """Global indices of the shards this process holds."""
        return range(self.rank, self.rank + 1) if self.distributed \
            else range(self.n_shards)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """send (n_local, n, M): row [l, t] is what held shard l sends to
        shard t. Returns recv (n_local, n, M): recv[l, t] = what shard t
        sent to held shard l."""
        if not self.distributed:
            return send.transpose(0, 1).contiguous()
        return self.start_all_to_all(send).wait()

    def start_all_to_all(self, send: torch.Tensor) -> Started:
        """`all_to_all(send)` started: its `Started` handle, whose
        `wait()` returns recv. On a local mesh the transpose is done at
        once."""
        if not self.distributed:
            recv = self.all_to_all(send)
            return Started(None, lambda: recv)
        recv = torch.empty_like(send[0])
        work = dist.all_to_all_single(recv, send[0].contiguous(), async_op=True)
        return Started(work, lambda: recv[None])

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """v (n_local, ...): one row per held shard -> (n_shards, ...),
        every shard's row in shard order."""
        if not self.distributed:
            return v
        return self.start_all_gather(v).wait()

    def start_all_gather(self, v: torch.Tensor) -> Started:
        """`all_gather(v)` started: its `Started` handle, whose `wait()`
        returns the (n_shards, ...) rows."""
        if not self.distributed:
            out = self.all_gather(v)
            return Started(None, lambda: out)
        parts = [torch.empty_like(v) for _ in range(self.n_shards)]
        work = dist.all_gather(parts, v.contiguous(), async_op=True)
        return Started(work, lambda: torch.cat(parts))


def make_mesh(axis: str = "shards", n_shards: Optional[int] = None,
              device=None, distributed: Optional[bool] = None) -> ShardMesh:
    """A one-axis mesh.

    `distributed` None means: a process-group mesh when a default
    process group exists, a local one otherwise. A process-group mesh
    has n_shards == world size (passing another count raises) and, by
    default, the device of its backend: this rank's current card under
    NCCL, the CPU under gloo. A local mesh takes any n_shards (default
    1) on `device`, by default `config.default_device()` (the card unless
    the process asked for the CPU); without a card it raises rather than
    place the mesh on the CPU unasked."""
    if distributed is None:
        distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh(distributed=True) needs a process "
                               "group; call init_distributed first")
        world = dist.get_world_size()
        if n_shards is not None and n_shards != world:
            raise ValueError(f"a process-group mesh has one shard per rank: "
                             f"n_shards={n_shards}, world size {world}")
        if device is None:
            device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return ShardMesh(axis, world, device_for(device, who="make_mesh"), True,
                         dist.get_rank())
    return ShardMesh(axis, 1 if n_shards is None else int(n_shards),
                     device_for(device, who="make_mesh", how='pass device="cpu"'))


def put_global(host_array, mesh: ShardMesh) -> torch.Tensor:
    """Place a host-replicated (n_shards, ...) array onto the mesh: the
    whole stack on a local mesh, this rank's (1, ...) row on a
    process-group mesh. Every process must hold the same array, which
    is true of every plan product: each is a deterministic function of
    the replicated CSR."""
    a = np.asarray(host_array)
    if a.shape[0] != mesh.n_shards:
        raise ValueError(f"leading axis {a.shape[0]} != n_shards "
                         f"{mesh.n_shards}")
    if mesh.distributed:
        a = a[mesh.rank:mesh.rank + 1]
    return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
