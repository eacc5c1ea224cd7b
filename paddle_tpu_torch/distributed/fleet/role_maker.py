"""Role makers — counterpart of
``paddle_tpu/distributed/fleet/role_maker.py`` (reference:
fleet/base/role_maker.py:357,528,875).

The ``PADDLE_*`` launcher variables name the worker; without them, the
job's process index and count (``distributed/process.py``).
"""
from __future__ import annotations

import os

from .. import process


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def _is_first_worker(self):
        return self._worker_index() == 0

    def _worker_index(self):
        raise NotImplementedError

    def _worker_num(self):
        raise NotImplementedError

    def _role(self):
        return Role.WORKER


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` like the
    reference; falls back to the job's process index and count."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective

    def _worker_index(self):
        env = os.environ.get("PADDLE_TRAINER_ID")
        return int(env) if env is not None else process.index()

    def _worker_num(self):
        env = os.environ.get("PADDLE_TRAINERS_NUM")
        return int(env) if env is not None else process.count()

    def _is_server(self):
        return False


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, current_id=0, role=Role.WORKER,
                 worker_num=1, server_endpoints=None, **kwargs):
        self._current_id = current_id
        self._worker_n = worker_num
        self._role_v = role

    def _worker_index(self):
        return self._current_id

    def _worker_num(self):
        return self._worker_n

    def _role(self):
        return self._role_v
