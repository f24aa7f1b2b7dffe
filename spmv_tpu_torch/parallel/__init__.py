"""The multi-device layer: row partition and halo plan, shard meshes on
`torch.distributed`, `distribute_csr` (K11') and `distribute_stream`
(the stream pipeline per shard)."""

from spmv_tpu_torch.parallel.partition import RowPartition, partition_rows
from spmv_tpu_torch.parallel.dist_spmv import DistributedSpMV, distribute_csr
from spmv_tpu_torch.parallel.dist_stream import (
    DistributedStreamSpMV,
    distribute_stream,
)
from spmv_tpu_torch.parallel.bootstrap import (
    ShardMesh,
    init_distributed,
    make_mesh,
    put_global,
)

__all__ = [
    "RowPartition",
    "partition_rows",
    "DistributedSpMV",
    "distribute_csr",
    "DistributedStreamSpMV",
    "distribute_stream",
    "ShardMesh",
    "init_distributed",
    "make_mesh",
    "put_global",
]
