"""The port's meshes and parallel training — counterpart of
``paddle_tpu/distributed``: the ``(mp, dp)`` serving mesh and the hybrid
``build_mesh`` grid of ranks over devices under one controller
(``mesh``), the collectives (``collective``), the sharding specs and
tensor-parallel layers (``sharding``), ``DataParallel`` and the parallel
environment (``parallel``), ``fleet``, train-state checkpoints
(``checkpoint``), Mixture-of-Experts (``moe``) and sequence-parallel
attention (``ring``)."""
from . import checkpoint  # noqa: F401
from . import fleet  # noqa: F401
from .collective import (ReduceOp, all_gather, all_gather_object,  # noqa: F401
                         all_reduce, all_reduce_sum, alltoall, barrier,
                         broadcast, current_rank, get_group, irecv, isend,
                         p2p_shift, parallel_region, recv, reduce,
                         reduce_scatter, run_ranks, scatter, send)
from .mesh import (AXES, DATA_AXES, DeviceMesh, ServingMesh,  # noqa: F401
                   axis_size, build_mesh, data_parallel_size, ensure_mesh,
                   get_mesh, serving_mesh, set_mesh)
from .moe import (ExpertFFN, MoELayer, collect_moe_aux_loss,  # noqa: F401
                  top_k_gating, top_k_routing)
from .parallel import (DataParallel, ParallelEnv, get_rank,  # noqa: F401
                       get_world_size, init_parallel_env, is_initialized,
                       spawn)
from .ring import ring_attention, ulysses_attention  # noqa: F401
from .sharding import (SERVING_SPECS, ColumnParallelLinear,  # noqa: F401
                       RowParallelLinear, VocabParallelEmbedding, shard,
                       shard_params_specs, shard_tensor, split, unshard)
