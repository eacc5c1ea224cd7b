"""The port's extension functionals (``grid_sample``, the CRF, Viterbi,
``gather_tree`` ...) and attention functionals held to the JAX package's
on the CPU: every functional case of those sections of
``tests/torch_nn_cases.py`` (the attention layers are
``test_torch_nn_transformer.py``'s), the same seeded numpy inputs and
weights through both packages, outputs at the case's tolerance (fp32
rtol/atol 1e-5; chains of transcendentals and reductions 1e-4), the
gradients of every differentiable case, the attention layers' too, at
1e-4 (the JAX side traced whole, ``torch_nn_jax.py``); integer outputs
(``gather_tree``, ``viterbi_decode``'s path, ``hash``) exactly.
"""
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as core_device

import torch_nn_cases as C
import torch_nn_jax as R

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


SECTIONS = ("extension", "attention")
CASES = [c for c in C.CASES if c[5] in SECTIONS and c[0].startswith("F.")]
GRAD = [c for c in C.CASES if c[5] in SECTIONS and c[4]]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(case):
    C.parity(P, lambda c: R.reference(c, c[4]), case, grad=False)


@pytest.mark.parametrize("case", GRAD, ids=[c[0] for c in GRAD])
def test_grad_matches_jax(case):
    C.parity(P, lambda c: R.reference(c, True), case, grad=True)
