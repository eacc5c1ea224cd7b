"""Data parallel and the parallel environment — counterpart of
``paddle_tpu/distributed/parallel.py``.

``init_parallel_env`` joins the job the launcher's env contract names
(``distributed/process.py``: ``torch.distributed.init_process_group``
over a TCP store at the first trainer endpoint, with an explicit
timeout, gloo or NCCL by topology), where the JAX package calls
``jax.distributed.initialize``, and builds the process mesh, which spans
every process's devices.  ``get_rank`` is the process's index
(``jax.process_index``), ``get_world_size`` the process mesh's
data-parallel degree.  ``DataParallel`` is a marker wrapper: ``TrainStep``
unwraps it and splits the batch over the data axes, where the gradients
are summed (no Reducer).  ``spawn`` calls ``func`` in this process, as
the JAX package's does: one process drives every local device, and the
launcher starts one process a node (``--nproc_per_node`` more).
"""
from __future__ import annotations

import contextlib
import os

from torch import nn

from . import mesh as mesh_mod
from . import process


def init_parallel_env():
    """reference: python/paddle/distributed/parallel.py:57.  Joins the
    job (a failed init raises; ``PADDLE_DIST_TIMEOUT_S``, 60 s by
    default, bounds the join and every later collective) and sets the
    process mesh over every process's devices (``ensure_mesh``)."""
    process.init()
    mesh_mod.ensure_mesh()
    return ParallelEnv()


def get_rank(group=None):
    return process.index()


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
    """reference: distributed/spawn.py.  One process drives every local
    device, so spawn is a direct call, as in the JAX package; several
    processes come from the launcher (``distributed/launch.py``)."""
    func(*args)
