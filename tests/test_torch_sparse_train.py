"""Sparse embedding training (``tests/torch_sparse_checks.py``) at a
small table: on the CPU here, and on the card under the ``cuda`` marker
(phase 24 (b) of ``chip_smoke.py`` runs the same checks at gpt2-medium's
table).  Imports no jax, so it runs on the card with ``--noconftest``."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch as P  # noqa: E402
from paddle_tpu_torch.core import device as core_device  # noqa: E402

import torch_sparse_checks as S  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def place():
    prev = core_device._current
    yield
    core_device._current = prev


def test_sparse_training_checks_on_cpu(place):
    P.set_device("cpu")
    res = S.check_all(P, vocab=512, dim=16, batch=4, seq=32)
    assert res["adam_lazy"]["untouched_rows"] > 0
    assert res["sgd"]["grad_bytes"] == 4 * 32 * 16 * 4
    assert res["sgd"]["dense_grad_bytes"] == 512 * 16 * 4


@pytest.mark.cuda
def test_sparse_training_checks_on_card(place):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    P.set_device("gpu")
    res = S.check_all(P, vocab=4096, dim=64, batch=4, seq=128)
    assert res["adam_lazy"]["untouched_rows"] > 0


@pytest.mark.cuda
def test_card_and_cpu_agree(place):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w0, ids = S.make_inputs(1024, 32, 2, 64)
    outs = []
    for dev in ("cpu", "gpu"):
        P.set_device(dev)
        w, _, _, _ = S.train(P, "adam_lazy", w0, ids, True, 3)
        outs.append(w.numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)
