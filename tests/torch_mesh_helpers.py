"""Shared pieces of the mesh-training parity tests
(``test_torch_mesh_train.py``, ``test_torch_pipeline.py``,
``test_torch_fleet.py``): the same weights in both packages, a JAX mesh
and the port's CPU mesh of the same shape, and the comparisons."""
import numpy as np
import torch

import jax

from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu_torch.convert import (export_paddle_tpu_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.distributed import build_mesh

LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4

TINY = dict(num_layers=2, hidden_size=64, num_heads=4, vocab_size=128,
            max_position=64, dropout=0.0)


def meshes(**shape):
    """The JAX mesh over the first devices of the forced 8-device pool and
    the port's mesh of the same shape over the CPU.  The JAX mesh also
    becomes JAX's process mesh, which its ``shard_params_specs`` and its
    sequence-parallel attention read (the ``jax_process_mesh`` fixture
    restores it)."""
    n = int(np.prod(list(shape.values())))
    jm = jmesh.set_mesh(jmesh.build_mesh(devices=jax.devices()[:n],
                                         **shape))
    return jm, build_mesh(devices=["cpu"] * n, **shape)


def bridge(jax_model, torch_model):
    """Copy the JAX model's parameters into the port's model."""
    load_paddle_tpu_state(torch_model, {
        n: np.asarray(p._data) for n, p in jax_model.named_parameters()})
    return torch_model


def jax_params(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


def assert_params_close(jax_model, torch_model):
    jp = jax_params(jax_model)
    tp = export_paddle_tpu_state(torch_model)
    assert sorted(jp) == sorted(tp)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=n)


def run_both(jstep, tstep, inputs, labels=(), steps=3):
    """``steps`` steps of each; the losses compared at ``LOSS_RTOL``;
    returns them."""
    jl = [float(jstep.step(list(inputs), list(labels)).numpy())
          for _ in range(steps)]
    tl = [float(tstep.step([torch.as_tensor(a) for a in inputs],
                           [torch.as_tensor(a) for a in labels]))
          for _ in range(steps)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    return jl, tl


def strip(spec):
    """A spec without trailing Nones, as a tuple."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def flip(spec, ndim):
    """A spec of a torch ``nn.Linear`` weight in the JAX layout."""
    spec = list(spec) + [None] * (ndim - len(spec))
    spec[-1], spec[-2] = spec[-2], spec[-1]
    return tuple(spec)
