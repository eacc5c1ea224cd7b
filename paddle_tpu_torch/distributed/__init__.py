"""The serving mesh of the port: ``(mp, dp)`` ranks over devices under
one controller, the serving layouts and tensor-parallel layers, and the
two collectives the tensor-parallel serving tick runs."""
from .collective import all_gather, all_reduce_sum  # noqa: F401
from .mesh import (ServingMesh, get_mesh, serving_mesh,  # noqa: F401
                   set_mesh)
from .sharding import (SERVING_SPECS, ColumnParallelLinear,  # noqa: F401
                       RowParallelLinear, VocabParallelEmbedding, shard,
                       unshard)
