"""Process-mesh parallelism: the mesh, the partition rules, the tp
operators and layers, ring attention and the launcher.

Counterpart of ``vilbert_multitask_tpu/parallel/``. One process (rank)
per device, ``torch.distributed`` collectives written out where XLA
inserted them for the JAX package (parallel/tp.py, parallel/ring.py).
The JAX names that place arrays on devices (``param_shardings``,
``batch_shardings``, ``shard_params``) have no counterpart: each rank
holds its own shards (parallel/sharding.py).
"""

from vilbert_multitask_tpu_torch.parallel.mesh import (
    axis,
    build_mesh,
    local_mesh_info,
)
from vilbert_multitask_tpu_torch.parallel.ring import (
    make_ring_attention,
    ring_attention_shard,
)
from vilbert_multitask_tpu_torch.parallel.sharding import (
    batch_spec,
    param_specs,
    place_batch,
)

__all__ = [
    "axis",
    "build_mesh",
    "local_mesh_info",
    "batch_spec",
    "make_ring_attention",
    "param_specs",
    "place_batch",
    "ring_attention_shard",
]
