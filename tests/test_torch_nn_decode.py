"""The port's beam search held to the JAX package's on the CPU:
``BeamSearchDecoder`` + ``dynamic_decode`` over a ``GRUCell`` with an
``Embedding`` and a ``Linear`` carried from the JAX layers gives the
JAX package's ids and lengths exactly (inputs without exact ties among
the candidates: continuous random weights), with ``return_length``,
``output_time_major``, early stopping and a decoder of the user's own;
``beam_search_decode`` turns ids into the two-level ``RaggedTensor`` of
``test_ragged.py``'s cases (the ones slice 17 deferred)."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.nn.decode import beam_search_decode as j_bsd
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.nn.decode import beam_search_decode

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _decoders(beam=3, vocab=12, hidden=16):
    J.seed(5)
    parts = {}
    for pkg in (J, P):
        nn = pkg.nn
        parts[pkg] = (nn.GRUCell(8, hidden), nn.Embedding(vocab, 8),
                      nn.Linear(hidden, vocab))
    for jl, pl in zip(parts[J], parts[P]):
        pl.set_state_dict({k: v.numpy() * 3.0 for k, v in
                           jl.state_dict().items()})
        jl.set_state_dict({k: v.numpy() * 3.0 for k, v in
                           jl.state_dict().items()})
    return {pkg: pkg.nn.BeamSearchDecoder(
        c, start_token=0, end_token=1, beam_size=beam, embedding_fn=e,
        output_fn=o) for pkg, (c, e, o) in parts.items()}


@pytest.mark.parametrize("steps,time_major", [(7, False), (30, True)])
def test_dynamic_decode_ids_equal_jax(steps, time_major):
    decs = _decoders()
    init = np.random.RandomState(5).rand(4, 16).astype(np.float32)
    res = {pkg: pkg.nn.dynamic_decode(
        decs[pkg], inits=pkg.to_tensor(init), max_step_num=steps,
        output_time_major=time_major, return_length=True)
        for pkg in (J, P)}
    ids, lens = (t.numpy() for t in res[P])
    np.testing.assert_array_equal(ids, res[J][0].numpy())
    np.testing.assert_array_equal(lens, res[J][1].numpy())
    assert isinstance(res[P][0], P.Tensor)
    out = P.nn.dynamic_decode(decs[P], inits=torch.tensor(init),
                              max_step_num=3)
    assert type(out) is torch.Tensor and tuple(out.shape)[:2] == (4, 3)


def test_decode_length_of_a_first_step_end():
    """``test_nn_extras.py``: a sequence ending at step 0 has length 1."""
    class EndsAtOnce:
        end_token = 1

        def initialize(self, inits):
            z = torch.zeros((1, 1))
            return (z.long(), {}, z, z.bool())

        def step(self, inputs, states):
            return torch.tensor([[0.0, 10.0, 0.0]]), states

    ids, lens = P.nn.dynamic_decode(EndsAtOnce(), max_step_num=5,
                                    return_length=True)
    assert int(lens[0, 0]) == 1 and tuple(ids.shape) == (1, 1, 1)


def test_tile_beam_merge_with_batch():
    x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    out = P.nn.BeamSearchDecoder.tile_beam_merge_with_batch(x, 2)
    np.testing.assert_array_equal(out.numpy(), np.repeat(x.numpy(), 2, 0))


@pytest.mark.parametrize("end_token", [None, 2])
def test_beam_search_decode_nested(end_token):
    ids = np.array([[[5, 6, 2, 0], [7, 2, 0, 0]],
                    [[8, 9, 9, 2], [3, 2, 0, 0]]], np.int32)
    lens = np.array([[3, 2], [4, 4]], np.int32)
    got = beam_search_decode(P.to_tensor(ids), P.to_tensor(lens),
                             end_token=end_token)
    want = j_bsd(J.to_tensor(ids), J.to_tensor(lens), end_token=end_token)
    assert got.lod_level == want.lod_level == 2
    for g_src, w_src in zip(got.nested_rows(), want.nested_rows()):
        assert len(g_src) == len(w_src)
        for g, w in zip(g_src, w_src):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="exceeds"):
        beam_search_decode(P.to_tensor(ids), P.to_tensor(lens + 1))
