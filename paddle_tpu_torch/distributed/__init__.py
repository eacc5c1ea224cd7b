"""The port's meshes and parallel training — counterpart of
``paddle_tpu/distributed``: the ``(mp, dp)`` serving mesh and the hybrid
``build_mesh`` grid of ranks over devices, which may span processes
(``mesh``), the processes of a job and the transport between them
(``process``), the collectives (``collective``), the sharding specs and
tensor-parallel layers (``sharding``), ``DataParallel`` and the parallel
environment (``parallel``), the launcher (``launch``), ``fleet``,
train-state checkpoints (``checkpoint``), Mixture-of-Experts (``moe``),
sequence-parallel attention (``ring``) and the parameter-server tables
(``ps``)."""
from . import checkpoint  # noqa: F401
from . import fleet  # noqa: F401
from . import process  # noqa: F401
from .collective import (ReduceOp, all_gather, all_gather_object,  # noqa: F401
                         all_reduce, all_reduce_sum, alltoall, barrier,
                         broadcast, current_rank, get_group, irecv, isend,
                         p2p_shift, parallel_region, recv, reduce,
                         reduce_scatter, run_ranks, scatter, send)
from .mesh import (AXES, DATA_AXES, DeviceMesh, RankPieces,  # noqa: F401
                   ServingMesh, axis_size, build_mesh, data_parallel_size,
                   ensure_mesh, get_mesh, global_from_replicated,
                   host_local_to_global, serving_mesh, set_mesh)
from .moe import (ExpertFFN, MoELayer, collect_moe_aux_loss,  # noqa: F401
                  top_k_gating, top_k_routing)
from .parallel import (DataParallel, ParallelEnv, get_rank,  # noqa: F401
                       get_world_size, init_parallel_env, is_initialized,
                       spawn)
from .ps import (DistributedEmbedding, GeoSparseTable,  # noqa: F401
                 GeoWorkerTable, HashedSparseTable, SparseTable, TheOnePS,
                 get_ps_runtime)
from .ring import ring_attention, ulysses_attention  # noqa: F401
from .sharding import (SERVING_SPECS, ColumnParallelLinear,  # noqa: F401
                       RowParallelLinear, VocabParallelEmbedding, shard,
                       shard_params_specs, shard_tensor, split, unshard)
from ..io.native_dataset import InMemoryDataset, QueueDataset  # noqa: F401


def launch_main(argv=None):
    """The launcher's entry point (``distributed/launch.py``), imported
    when called so that ``python -m paddle_tpu_torch.distributed.launch``
    finds its module unimported."""
    from .launch import launch_main as main
    return main(argv)
