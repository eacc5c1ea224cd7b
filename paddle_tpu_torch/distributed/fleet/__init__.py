"""Fleet — the distributed-training facade, counterpart of
``paddle_tpu/distributed/fleet/__init__.py``.

Reference parity: ``fleet.init / distributed_optimizer /
distributed_model / minimize`` (``fleet/base/fleet_base.py:63,130,594,
1066``), ``DistributedStrategy`` (``strategy.py``), meta-optimizer
selection (``base/meta_optimizer_factory.py`` +
``strategy_compiler.py:89``).

As in the JAX package the strategy is declarative: ``init`` builds the
hybrid ``DeviceMesh`` from ``hybrid_configs`` over the given devices
(default every CUDA card) and sets it as the process mesh;
``build_train_step`` picks the step the strategy asks for — a
``meta_optimizers`` step for ``adaptive_localsgd`` / ``localsgd`` /
``dgc`` / ``fp16_allreduce``, else ``TrainStep``, which maps amp,
sharding, the hybrid axes, the pipeline and gradient merge itself.
``utils.recompute`` is the dygraph recompute.
"""
from __future__ import annotations

import os

from .. import mesh as mesh_mod
from ..parallel import get_rank, get_world_size
from . import meta_parallel  # noqa: F401
from . import utils  # noqa: F401
from .role_maker import (PaddleCloudRoleMaker, Role,  # noqa: F401
                         UserDefinedRoleMaker)
from .strategy import DistributedStrategy
from .utils import recompute  # noqa: F401

_fleet_state = {
    "initialized": False,
    "strategy": None,
    "role_maker": None,
}


def init(role_maker=None, is_collective=True, strategy=None, devices=None):
    """Parse the role and build the hybrid mesh from
    ``strategy.hybrid_configs`` over ``devices`` (default every CUDA
    card): ``dp_degree`` 0 fills dp with what the other degrees leave, as
    in the JAX package.  Sets it as the process mesh and returns it."""
    import torch
    strategy = strategy or DistributedStrategy()
    _fleet_state["strategy"] = strategy
    _fleet_state["role_maker"] = role_maker or PaddleCloudRoleMaker(
        is_collective=is_collective)
    hybrid = strategy.hybrid_configs
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    dp = hybrid.get("dp_degree", 0) or 0
    mp = hybrid.get("mp_degree", 1)
    pp = hybrid.get("pp_degree", 1)
    sharding = hybrid.get("sharding_degree", 1)
    sp = hybrid.get("sep_degree", 1) or hybrid.get("sp_degree", 1)
    used = mp * pp * sharding * sp
    if dp <= 0:
        dp = max(1, n // used)
    mesh = mesh_mod.set_mesh(mesh_mod.build_mesh(
        dp=dp, sharding=sharding, pp=pp, mp=mp, sp=sp,
        devices=devices[:dp * used]))
    _fleet_state["initialized"] = True
    return mesh


def is_first_worker():
    return get_rank() == 0


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def get_hybrid_communicate_group():
    from . import topology
    return topology.HybridCommunicateGroup(mesh_mod.ensure_mesh())


def distributed_model(model):
    """The model as the strategy trains it: a ``PipelineLayer`` under
    ``pp_degree > 1`` (anything else raises), else ``DataParallel``."""
    from ..parallel import DataParallel
    strategy = _fleet_state["strategy"] or DistributedStrategy()
    if strategy.hybrid_configs.get("pp_degree", 1) > 1:
        from .meta_parallel import PipelineLayer
        if not isinstance(model, PipelineLayer):
            raise ValueError(
                "pp_degree>1 requires a PipelineLayer model "
                "(see paddle_tpu_torch.distributed.fleet.meta_parallel)")
        return model
    return DataParallel(model)


class DistributedOptimizer:
    """The optimizer with the strategy it trains under; the strategy is
    read by ``build_train_step`` / ``TrainStep``."""

    def __init__(self, optimizer, strategy):
        self.inner_opt = optimizer
        self.user_defined_strategy = strategy

    def __getattr__(self, name):
        return getattr(self.inner_opt, name)

    def step(self):
        return self.inner_opt.step()

    def clear_grad(self):
        return self.inner_opt.clear_grad()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self.inner_opt.minimize(loss, startup_program, parameters,
                                       no_grad_set)


def distributed_optimizer(optimizer, strategy=None):
    strategy = strategy or _fleet_state["strategy"] or DistributedStrategy()
    _fleet_state["strategy"] = strategy
    return DistributedOptimizer(optimizer, strategy)


def get_strategy():
    return _fleet_state["strategy"]


def build_train_step(model, optimizer, loss_fn=None, strategy=None,
                     **kwargs):
    """The step the strategy selects (the reference's meta-optimizer
    choice): ``AdaptiveLocalSGDStep``, ``LocalSGDStep``, ``DGCStep``,
    ``FP16AllReduceStep``, else ``TrainStep``."""
    from ...parallel.train_step import TrainStep
    from .meta_optimizers import (AdaptiveLocalSGDStep, DGCStep,
                                  FP16AllReduceStep, LocalSGDStep)
    strategy = strategy or _fleet_state["strategy"] or DistributedStrategy()
    if isinstance(optimizer, DistributedOptimizer):
        optimizer = optimizer.inner_opt
    mesh = kwargs.pop("mesh", None)
    if getattr(strategy, "adaptive_localsgd", False):
        cfg = strategy.adaptive_localsgd_configs
        return AdaptiveLocalSGDStep(
            model, optimizer, loss_fn=loss_fn, mesh=mesh,
            init_k_steps=cfg.get("init_k_steps", 1),
            begin_step=cfg.get("begin_step", 1))
    if strategy.localsgd:
        return LocalSGDStep(model, optimizer, loss_fn=loss_fn, mesh=mesh,
                            k_steps=strategy.localsgd_configs.get(
                                "k_steps", 2))
    if strategy.dgc:
        return DGCStep(model, optimizer, loss_fn=loss_fn, mesh=mesh)
    if strategy.fp16_allreduce:
        return FP16AllReduceStep(model, optimizer, loss_fn=loss_fn,
                                 mesh=mesh)
    return TrainStep(model, optimizer, loss_fn=loss_fn, strategy=strategy,
                     mesh=mesh, **kwargs)


def save_persistables(model, dirname, **kwargs):
    """The model's state (reference: fleet_base.py:518) through
    ``checkpoint.save_sharded`` under ``dirname/persistables``."""
    from ..checkpoint import save_sharded
    save_sharded(model.state_dict(), os.path.join(dirname, "persistables"))


class Fleet:
    """Class facade over this module's singleton state (the reference's
    ``fleet`` object is a Fleet instance)."""

    def init(self, role_maker=None, is_collective=True, strategy=None,
             devices=None):
        return init(role_maker, is_collective, strategy, devices)

    def is_first_worker(self):
        return is_first_worker()

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()

    def distributed_model(self, model):
        return distributed_model(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)

    def save_persistables(self, *a, **k):
        return save_persistables(*a, **k)
