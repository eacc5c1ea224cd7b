"""Hybrid topology view — counterpart of
``paddle_tpu/distributed/fleet/topology.py`` (reference:
HybridCommunicateGroup — rank <-> (dp, sharding, pp, mp) coordinates).
The port's ``DeviceMesh`` is the topology; this exposes its axis sizes.
Ranks are process-level, and the one controller process is rank 0 of
every group."""
from __future__ import annotations

from .. import mesh as mesh_mod


class HybridCommunicateGroup:
    def __init__(self, mesh=None):
        self._mesh = mesh if mesh is not None else mesh_mod.ensure_mesh()

    def get_data_parallel_world_size(self):
        return self._mesh.axis_size("dp")

    def get_model_parallel_world_size(self):
        return self._mesh.axis_size("mp")

    def get_pipe_parallel_world_size(self):
        return self._mesh.axis_size("pp")

    def get_sharding_parallel_world_size(self):
        return self._mesh.axis_size("sharding")

    def get_sep_parallel_world_size(self):
        return self._mesh.axis_size("sp")

    def get_data_parallel_rank(self):
        return 0

    def get_model_parallel_rank(self):
        return 0

    def get_stage_id(self):
        return 0

    def topology(self):
        return dict(self._mesh.shape)

    def get_model_parallel_group(self):
        return "mp"

    def get_data_parallel_group(self):
        return "dp"

    def get_pipe_parallel_group(self):
        return "pp"
