"""Data parallel and the parallel environment — counterpart of
``paddle_tpu/distributed/parallel.py``.

The port is one controller process driving every rank of a mesh
(``distributed/mesh.py``), as the JAX package's one process drives its
devices: ``get_rank`` is that process's index (0), ``get_world_size``
the process mesh's data-parallel degree.  ``DataParallel`` is a marker
wrapper: ``TrainStep`` unwraps it and splits the batch over the data
axes, where the gradients are summed (no Reducer).  ``spawn`` would
start one process a rank: that multi-process form is ROADMAP Queue
A 12's.
"""
from __future__ import annotations

import contextlib
import os

from torch import nn

from . import mesh as mesh_mod


def init_parallel_env():
    """The process mesh over every card (``ensure_mesh``)."""
    mesh_mod.ensure_mesh()
    return ParallelEnv()


def get_rank(group=None):
    return 0


def get_world_size(group=None):
    if mesh_mod.get_mesh() is None:
        return 1
    return mesh_mod.data_parallel_size()


def is_initialized():
    return mesh_mod.get_mesh() is not None


class ParallelEnv:
    """reference: fluid/dygraph/parallel.py ParallelEnv (env-var view)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    local_rank = rank
    nranks = world_size


class DataParallel(nn.Module):
    """``paddle.DataParallel``: forwards to the wrapped model, whose state
    it passes through; ``TrainStep`` unwraps it."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        pass

    @contextlib.contextmanager
    def no_sync(self):
        yield

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    raise NotImplementedError(
        "distributed.spawn starts one process a rank; the port drives every "
        "rank from one process (build a mesh and use TrainStep), and the "
        "multi-process form is not ported yet (ROADMAP Queue A 12)")
