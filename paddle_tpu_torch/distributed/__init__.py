"""The port's meshes and parallel layers: the ``(mp, dp)`` serving mesh
and the hybrid ``build_mesh`` grid of ranks over devices under one
controller, the serving layouts and tensor-parallel layers, the two
collectives the tensor-parallel serving tick runs, Mixture-of-Experts
(``moe``) and sequence-parallel attention (``ring``)."""
from .collective import all_gather, all_reduce_sum  # noqa: F401
from .mesh import (AXES, DeviceMesh, ServingMesh, build_mesh,  # noqa: F401
                   get_mesh, serving_mesh, set_mesh)
from .moe import (ExpertFFN, MoELayer, collect_moe_aux_loss,  # noqa: F401
                  top_k_gating, top_k_routing)
from .ring import ring_attention, ulysses_attention  # noqa: F401
from .sharding import (SERVING_SPECS, ColumnParallelLinear,  # noqa: F401
                       RowParallelLinear, VocabParallelEmbedding, shard,
                       unshard)
