"""The port's ``RaggedTensor`` and sequence ops held to the JAX
package's ``core/ragged.py`` on the CPU: the cases of
``test_ragged.py``, each run in both packages on the same rows (floats
at rtol 1e-5, offsets and lengths exactly).  The JAX file's jit cases
have no counterpart (no trace here); its ``F.sequence_pad`` and
``beam_search_decode`` cases wait for slice 12b (``nn.functional``,
``nn.decode``).  Gradients through the ops are torch's, held to
``jax.grad`` of the JAX ops."""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.core import ragged as JR
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.core import ragged as PR

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _skewed(seed=0, dim=3):
    rs = np.random.RandomState(seed)
    return [rs.rand(n, dim).astype(np.float32) for n in (1, 5, 2, 7)]


def _nested(seed=3, dim=2):
    rs = np.random.RandomState(seed)
    return [
        [rs.rand(3, dim).astype(np.float32),
         rs.rand(1, dim).astype(np.float32)],
        [rs.rand(2, dim).astype(np.float32)],
        [rs.rand(4, dim).astype(np.float32),
         rs.rand(2, dim).astype(np.float32),
         rs.rand(1, dim).astype(np.float32)],
    ]


def both_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


def same(pt, jt):
    """A port RaggedTensor equals a JAX one."""
    assert pt.lod() == [[int(v) for v in lvl] for lvl in jt.lod()]
    both_rows(pt.rows(), jt.rows())
    np.testing.assert_allclose(pt.values.numpy(), jt.values.numpy(),
                               rtol=1e-5, atol=1e-6)


class TestRaggedCore:
    def test_roundtrip_padded(self):
        rows = _skewed()
        rt = PR.RaggedTensor.from_rows(rows)
        dense, lens = rt.to_padded(max_len=7)
        jd, jl = JR.RaggedTensor.from_rows(rows).to_padded(max_len=7)
        assert list(dense.shape) == [4, 7, 3]
        np.testing.assert_array_equal(lens.numpy(), jl.numpy())
        np.testing.assert_allclose(dense.numpy(), jd.numpy())
        rt2 = PR.RaggedTensor.from_padded(dense, lens)
        both_rows(rt2.rows(), rows)
        same(rt2, JR.RaggedTensor.from_padded(jd, jl))

    def test_capacity_bucket(self):
        rt = PR.RaggedTensor.from_rows(_skewed(), capacity=32)
        assert rt.capacity == 32
        both_rows(rt.rows(), _skewed())
        ids = rt.segment_ids().numpy()
        jids = np.asarray(JR.RaggedTensor.from_rows(
            _skewed(), capacity=32).segment_ids())
        np.testing.assert_array_equal(ids, jids)
        assert (ids[15:] == 4).all()

    def test_from_rows_capacity_too_small(self):
        with pytest.raises(ValueError, match="capacity"):
            PR.RaggedTensor.from_rows(_skewed(), capacity=10)

    def test_to_padded_too_short_raises(self):
        with pytest.raises(ValueError, match="max_len"):
            PR.RaggedTensor.from_rows(_skewed()).to_padded(max_len=4)

    def test_lengths_and_nrows(self):
        rt = PR.RaggedTensor.from_rows(_skewed(), capacity=20)
        assert rt.nrows == 4
        np.testing.assert_array_equal(rt.lengths().numpy(), [1, 5, 2, 7])


class TestRaggedOps:
    @pytest.mark.parametrize("ptype", ["sum", "mean", "sqrt", "max", "min",
                                       "first", "last", "average"])
    def test_pool_matches_jax(self, ptype):
        rows = _skewed(1)
        got = PR.sequence_pool(PR.RaggedTensor.from_rows(rows, capacity=20),
                               ptype).numpy()
        jrt = JR.RaggedTensor.from_rows(rows, capacity=20)
        want = JR.sequence_pool(jrt, ptype).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        if ptype in ("sum", "mean", "sqrt", "max", "first", "last"):
            dense, lens = jrt.to_padded(7)
            ref = JF.sequence_pool(dense, ptype, lengths=lens)
            ref = ref[0] if isinstance(ref, tuple) else ref
            np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5,
                                       atol=1e-6)

    def test_pool_unknown_type_raises(self):
        with pytest.raises(ValueError, match="pool_type"):
            PR.sequence_pool(PR.RaggedTensor.from_rows(_skewed()), "median")

    def test_softmax_matches_jax(self):
        rs = np.random.RandomState(2)
        rows = [rs.rand(n).astype(np.float32) for n in (3, 1, 6)]
        out = PR.sequence_softmax(PR.RaggedTensor.from_rows(rows,
                                                            capacity=16))
        same(out, JR.sequence_softmax(JR.RaggedTensor.from_rows(
            rows, capacity=16)))
        assert out.values.numpy()[10:].sum() == 0

    def test_reverse_matches_jax(self):
        rows = _skewed(3)
        rev = PR.sequence_reverse(PR.RaggedTensor.from_rows(rows,
                                                            capacity=20))
        same(rev, JR.sequence_reverse(JR.RaggedTensor.from_rows(
            rows, capacity=20)))
        for got, r in zip(rev.rows(), rows):
            np.testing.assert_allclose(got, r[::-1])

    def test_expand_as(self):
        rs = np.random.RandomState(4)
        xr = [rs.rand(1, 2).astype(np.float32) for _ in range(3)]
        rr = [rs.rand(n, 2).astype(np.float32) for n in (2, 4, 1)]
        out = PR.sequence_expand(PR.RaggedTensor.from_rows(xr),
                                 PR.RaggedTensor.from_rows(rr, capacity=10))
        same(out, JR.sequence_expand(JR.RaggedTensor.from_rows(xr),
                                     JR.RaggedTensor.from_rows(
                                         rr, capacity=10)))

    def test_concat_rowwise(self):
        rs = np.random.RandomState(5)
        a_rows = [rs.rand(n, 2).astype(np.float32) for n in (2, 0, 3)]
        b_rows = [rs.rand(n, 2).astype(np.float32) for n in (1, 2, 2)]
        out = PR.sequence_concat(PR.RaggedTensor.from_rows(a_rows, 8),
                                 PR.RaggedTensor.from_rows(b_rows, 8))
        same(out, JR.sequence_concat(JR.RaggedTensor.from_rows(a_rows, 8),
                                     JR.RaggedTensor.from_rows(b_rows, 8)))

    def test_empty_rows_pool(self):
        rows = [np.zeros((0, 2), np.float32), np.ones((3, 2), np.float32)]
        for ptype in ("mean", "max", "first"):
            got = PR.sequence_pool(PR.RaggedTensor.from_rows(rows, 8),
                                   ptype, pad_value=-1.0).numpy()
            want = JR.sequence_pool(JR.RaggedTensor.from_rows(rows, 8),
                                    ptype, pad_value=-1.0).numpy()
            np.testing.assert_allclose(got, want)
            np.testing.assert_allclose(got[0], [-1.0, -1.0])


class TestRaggedGrad:
    @pytest.mark.parametrize("op", ["mean", "max", "softmax", "reverse"])
    def test_grad_matches_jax(self, op):
        rows = ([np.random.RandomState(6).rand(n).astype(np.float32)
                 for n in (3, 2, 4)] if op == "softmax" else _skewed(6))
        jrt = JR.RaggedTensor.from_rows(rows, capacity=20)
        splits = jrt.row_splits._data

        def f(pkg_r, values, splits_):
            rt = pkg_r.RaggedTensor(values, splits_)
            if op == "softmax":
                return pkg_r.sequence_softmax(rt).values
            if op == "reverse":
                return pkg_r.sequence_reverse(rt).values
            return pkg_r.sequence_pool(rt, op)

        w = np.random.RandomState(9).rand(
            *np.asarray(f(JR, jrt.values, jrt.row_splits).numpy()).shape
        ).astype(np.float32)

        def jloss(v):
            return (f(JR, P_wrap(v), P_wrap(splits))._data * w).sum()

        def P_wrap(a):
            from paddle_tpu.core.tensor import Tensor
            return Tensor(a)

        want = np.asarray(jax.grad(jloss)(jrt.values._data))
        v = P.to_tensor(np.asarray(jrt.values._data), stop_gradient=False)
        out = f(PR, v, P.to_tensor(np.asarray(splits)))
        (out * P.to_tensor(w)).sum().backward()
        got = v.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.isfinite(got).all()

    def test_from_padded_capacity_overflow_raises(self):
        dense = P.to_tensor(np.ones((2, 6, 1), np.float32))
        lens = P.to_tensor(np.array([6, 6]))
        with pytest.raises(ValueError, match="silently drop"):
            PR.RaggedTensor.from_padded(dense, lens, capacity=8)

    def test_expand_nrows_mismatch_raises(self):
        rs = np.random.RandomState(1)
        x = PR.RaggedTensor.from_rows([rs.rand(1, 2).astype(np.float32)] * 2)
        ref = PR.RaggedTensor.from_rows([rs.rand(2, 2).astype(np.float32)]
                                        * 3)
        with pytest.raises(ValueError, match="rows"):
            PR.sequence_expand(x, ref)

    def test_expand_one_step_on_multi_step_rows_raises(self):
        x = PR.RaggedTensor.from_rows([np.ones((2, 1), np.float32)])
        ref = PR.RaggedTensor.from_rows([np.ones((3, 1), np.float32)])
        with pytest.raises(ValueError, match="one_step"):
            PR.sequence_expand(x, ref, one_step=True)


class TestNestedLoD:
    def test_construction_and_accessors(self):
        rt = PR.RaggedTensor.from_nested_rows(_nested())
        jt = JR.RaggedTensor.from_nested_rows(_nested())
        assert rt.lod_level == 2
        assert rt.lod() == [[0, 2, 3, 6], [0, 3, 4, 6, 10, 12, 13]]
        assert rt.recursive_sequence_lengths() == [
            [int(v) for v in lvl] for lvl in jt.recursive_sequence_lengths()]

    def test_nested_rows_roundtrip(self):
        back = PR.RaggedTensor.from_nested_rows(_nested()).nested_rows()
        for g_out, g_in in zip(back, _nested()):
            both_rows(g_out, g_in)

    def test_three_levels(self):
        rs = np.random.RandomState(0)
        lvl3 = [[[rs.rand(2, 2).astype(np.float32)],
                 [rs.rand(1, 2).astype(np.float32),
                  rs.rand(3, 2).astype(np.float32)]],
                [[rs.rand(2, 2).astype(np.float32)]]]
        rt = PR.RaggedTensor.from_nested_rows(lvl3)
        assert rt.lod_level == 3
        assert rt.lod()[:2] == [[0, 2, 3], [0, 1, 3, 4]]
        np.testing.assert_allclose(rt.nested_rows()[0][1][1],
                                   lvl3[0][1][1])

    def test_nested_pool_two_stages(self):
        nested = _nested()
        sent = PR.sequence_pool(PR.RaggedTensor.from_nested_rows(nested),
                                "sum")
        jsent = JR.sequence_pool(JR.RaggedTensor.from_nested_rows(nested),
                                 "sum")
        assert isinstance(sent, PR.RaggedTensor) and sent.lod_level == 1
        same(sent, jsent)
        doc = PR.sequence_pool(sent, "mean").numpy()
        np.testing.assert_allclose(
            doc, JR.sequence_pool(jsent, "mean").numpy(), rtol=1e-5)

    def test_lod_preserved_by_elementwise_ops(self):
        rt = PR.RaggedTensor.from_nested_rows(
            [[np.arange(3, dtype=np.float32)[:, None]],
             [np.arange(2, dtype=np.float32)[:, None],
              np.arange(1, dtype=np.float32)[:, None]]])
        assert PR.sequence_reverse(rt).lod() == rt.lod()

    def test_expand_whole_rows(self):
        x_rows = [np.array([[1.0], [2.0]], np.float32),
                  np.array([[3.0]], np.float32)]
        ref_rows = [np.zeros((2, 1), np.float32),
                    np.zeros((3, 1), np.float32)]
        out = PR.sequence_expand(PR.RaggedTensor.from_rows(x_rows),
                                 PR.RaggedTensor.from_rows(ref_rows))
        same(out, JR.sequence_expand(JR.RaggedTensor.from_rows(x_rows),
                                     JR.RaggedTensor.from_rows(ref_rows)))
        assert out.lod_level == 2 and out.lod()[0] == [0, 2, 5]

    def test_expand_nested_ref_level(self):
        x_rows = [np.array([[1.0], [2.0]], np.float32),
                  np.array([[3.0]], np.float32),
                  np.array([[4.0], [5.0]], np.float32)]
        out = PR.sequence_expand(
            PR.RaggedTensor.from_rows(x_rows),
            PR.RaggedTensor.from_nested_rows(_nested()), ref_level=0)
        same(out, JR.sequence_expand(
            JR.RaggedTensor.from_rows(x_rows),
            JR.RaggedTensor.from_nested_rows(_nested()), ref_level=0))
        assert [len(r) for r in out.rows()] == [2, 2, 1, 2, 2, 2]

    def test_expand_with_bounds(self):
        x = PR.RaggedTensor.from_rows([np.array([[1.0], [2.0]], np.float32),
                                       np.array([[3.0]], np.float32)])
        ref = PR.RaggedTensor.from_rows([np.zeros((2, 1), np.float32),
                                         np.zeros((1, 1), np.float32)])
        out = PR.sequence_expand(x, ref, capacity=16, max_out_rows=8)
        assert out.values.shape == [16, 1] and out.row_splits.shape == [9]
        np.testing.assert_allclose(out.values.numpy()[:5, 0],
                                   [1, 2, 1, 2, 3])

    def test_expand_undersized_bounds_raise(self):
        x = PR.RaggedTensor.from_rows([np.array([[1.0], [2.0]], np.float32),
                                       np.array([[3.0]], np.float32)])
        ref = PR.RaggedTensor.from_rows([np.zeros((2, 1), np.float32),
                                         np.zeros((3, 1), np.float32)])
        with pytest.raises(ValueError, match="capacity"):
            PR.sequence_expand(x, ref, capacity=4)
        with pytest.raises(ValueError, match="max_out_rows"):
            PR.sequence_expand(x, ref, max_out_rows=3)

    def test_to_padded_nested(self):
        nested = _nested()
        rt = PR.RaggedTensor.from_nested_rows(nested)
        dense, row_lens = rt.to_padded_nested(max_rows=3, max_len=4)
        jd, jl = JR.RaggedTensor.from_nested_rows(nested).to_padded_nested(
            max_rows=3, max_len=4)
        np.testing.assert_allclose(dense.numpy(), jd.numpy())
        np.testing.assert_array_equal(row_lens.numpy(), jl.numpy())
        with pytest.raises(ValueError):
            rt.to_padded_nested(max_rows=2, max_len=4)
        with pytest.raises(ValueError, match="lod_level"):
            PR.RaggedTensor.from_rows(_skewed()).to_padded_nested(2, 7)

    def test_concat_preserves_and_checks_outer_lod(self):
        a = PR.RaggedTensor.from_nested_rows(_nested())
        out = PR.sequence_concat(a, a)
        assert out.lod()[0] == a.lod()[0]
        for got, want in zip(out.rows(), a.rows()):
            np.testing.assert_allclose(got, np.concatenate([want, want], 0))
        flat = PR.RaggedTensor(a.values, a.row_splits)
        with pytest.raises(ValueError, match="lod_level"):
            PR.sequence_concat(a, flat)
