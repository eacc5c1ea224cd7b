"""The port's ``nn.functional.sequence`` held to the JAX package's on the
CPU: the sequence cases of ``test_sequence_text.py`` and the nested
``F.sequence_pad`` cases of ``test_ragged.py``, each run in both
packages on the same numpy inputs, plus every public function of the
module on seeded inputs with lengths that leave padding (a zero-length
row where the op allows one).  Outputs and the gradients of
``sum(out_k * w_k)`` with respect to the float inputs agree at rtol 1e-5
/ atol 1e-6; integer outputs exactly.  The JAX side of a gradient runs
traced whole (``jax.value_and_grad`` under ``jax.jit``), the lengths
closed over as constants."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.core import ragged as JR
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.core import ragged as PR

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _weights(shape, k):
    return np.asarray(np.random.RandomState(100 + k).rand(*shape),
                      np.float32)


def _jax_eager(fn, floats, grad):
    ts = [J.to_tensor(a, stop_gradient=not grad) for a in floats]
    outs = _flat(fn(J, *ts))
    if not grad:
        return [o.numpy() for o in outs], None
    loss = None
    for k, o in enumerate(outs):
        if o._data.dtype.kind == "f" and not o.stop_gradient:
            part = (o * J.to_tensor(_weights(o.shape, k))).sum()
            loss = part if loss is None else loss + part
    loss.backward()
    return [o.numpy() for o in outs], [t.grad.numpy() for t in ts]


def _jax(fn, floats, grad):
    """Traced whole; a case whose JAX code reads a traced value on the
    host (a lengths vector made inside the trace) runs eagerly."""
    try:
        return _jax_traced(fn, floats, grad)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError,
            jax.errors.TracerIntegerConversionError):
        return _jax_eager(fn, floats, grad)


def _jax_traced(fn, floats, grad):
    def run(fl):
        ts = [J.Tensor(a, stop_gradient=not grad) for a in fl]
        outs = _flat(fn(J, *ts))
        loss = 0.0
        for k, o in enumerate(outs):
            if o._data.dtype.kind == "f" and not o.stop_gradient:
                loss = loss + (o._data * _weights(o.shape, k)).sum()
        return loss, [o._data for o in outs]

    if not grad:
        return [np.asarray(o) for o in jax.jit(run)(floats)[1]], None
    (_, outs), g = jax.jit(jax.value_and_grad(run, has_aux=True))(floats)
    return [np.asarray(o) for o in outs], [np.asarray(x) for x in g]


def _port(fn, floats, grad):
    ts = [P.to_tensor(a, stop_gradient=not grad) for a in floats]
    outs = _flat(fn(P, *ts))
    if not grad:
        return [o.numpy() for o in outs], None
    loss = 0.0
    for k, o in enumerate(outs):
        if o.torch().is_floating_point() and o.torch().requires_grad:
            loss = loss + (o.torch() * torch.from_numpy(
                _weights(o.shape, k))).sum()
    loss.backward()
    return [o.numpy() for o in outs], [t.grad.numpy() for t in ts]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, (x.shape, y.shape)
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, **TOL)
        else:
            np.testing.assert_array_equal(x, y)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


LENS = np.array([5, 1, 0, 3], np.int64)      # [B] over T = 5
LENS_FULL = np.array([5, 1, 2, 3], np.int64)
X = _rand(4, 5, 3)
IDS = np.random.RandomState(3).randint(1, 6, (4, 5)).astype(np.int64)

# (id, fn(pkg, *float tensors), float inputs, gradient?); the JAX
# package's sequence_topk_avg_pooling gives no gradient (its output is
# made outside the tape), so that case compares outputs only
CASES = [
    *[(f"pool_{t}", (lambda t: lambda pkg, x: pkg.nn.functional.sequence_pool(
        x, t, LENS, pad_value=-2.0))(t), [X], True)
      for t in ("sum", "average", "max", "min", "sqrt", "first", "last")],
    ("pool_no_lengths", lambda pkg, x: pkg.nn.functional.sequence_pool(
        x, "max"), [X], True),
    ("softmax", lambda pkg, x: pkg.nn.functional.sequence_softmax(
        x, LENS_FULL), [_rand(4, 5, seed=1)], True),
    ("reverse", lambda pkg, x: pkg.nn.functional.sequence_reverse(
        x, LENS), [X], True),
    ("expand", lambda pkg, x: pkg.nn.functional.sequence_expand(
        x, np.array([2, 0, 3, 1], np.int64)), [_rand(4, 3)], True),
    ("unpad", lambda pkg, x: pkg.nn.functional.sequence_unpad(
        x, LENS), [X], True),
    ("row_conv", lambda pkg, x, w: pkg.nn.functional.row_conv(x, w),
     [X, _rand(3, 3, seed=2)], True),
    ("row_conv_act", lambda pkg, x, w: pkg.nn.functional.row_conv(
        x, w, act="relu"), [X - 0.5, _rand(2, 3, seed=2)], True),
    ("first_step", lambda pkg, x: pkg.nn.functional.sequence_first_step(
        x, LENS), [X], True),
    ("last_step", lambda pkg, x: pkg.nn.functional.sequence_last_step(
        x, LENS), [X], True),
    ("concat", lambda pkg, a, b: pkg.nn.functional.sequence_concat(
        [a, b], [LENS, np.array([2, 0, 1, 2], np.int64)]),
     [X, _rand(4, 2, 3, seed=4)], True),
    ("concat_full", lambda pkg, a, b: pkg.nn.functional.sequence_concat(
        [a, b]), [X, _rand(4, 2, 3, seed=4)], True),
    ("expand_as", lambda pkg, x: pkg.nn.functional.sequence_expand_as(
        x, np.array([3, 1, 0, 2], np.int64)), [_rand(4, 3)], True),
    ("slice", lambda pkg, x: pkg.nn.functional.sequence_slice(
        x, np.array([0, 1, 2, 1], np.int64),
        np.array([3, 2, 1, 4], np.int64)), [X], True),
    ("scatter", lambda pkg, x, u: pkg.nn.functional.sequence_scatter(
        x, np.array([[0, 2, 2], [1, 0, 4], [3, 3, 3], [4, 1, 0]],
                    np.int64), u, np.array([3, 1, 0, 2], np.int64)),
     [_rand(4, 5), _rand(4, 3, seed=5)], True),
    ("conv", lambda pkg, x, w, b: pkg.nn.functional.sequence_conv(
        x, w, b, context_length=3, lengths=LENS_FULL),
     [X, _rand(9, 4, seed=6), _rand(4, seed=7)], True),
    ("conv_start", lambda pkg, x, w: pkg.nn.functional.sequence_conv(
        x, w, context_length=2, context_start=0, padding_value=0.5),
     [X, _rand(6, 2, seed=6)], True),
    ("topk_avg_pooling",
     lambda pkg, x: pkg.nn.functional.sequence_topk_avg_pooling(
         x, np.array([4, 2], np.int64), np.array([6, 3], np.int64),
         topks=[1, 3], channel_num=3), [_rand(2, 3, 4, 6)], False),
    ("enumerate", lambda pkg: pkg.nn.functional.sequence_enumerate(
        IDS, 3, pad_value=0, lengths=LENS_FULL), [], False),
    ("reshape", lambda pkg, x: pkg.nn.functional.sequence_reshape(
        x, 5, LENS_FULL), [_rand(4, 5, 2)], True),
    ("erase", lambda pkg: pkg.nn.functional.sequence_erase(
        IDS, [1, 3], lengths=LENS_FULL), [], False),
    ("edit_distance", lambda pkg: pkg.nn.functional.edit_distance(
        IDS, np.random.RandomState(9).randint(1, 6, (4, 6)),
        normalized=True, input_length=LENS,
        label_length=np.array([6, 0, 3, 2], np.int64)), [], False),
    ("edit_distance_raw", lambda pkg: pkg.nn.functional.edit_distance(
        IDS, np.random.RandomState(9).randint(1, 4, (4, 6)),
        normalized=False), [], False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_matches_jax(case):
    _, fn, floats, grad = case
    jo, jg = _jax(fn, floats, grad)
    po, pg = _port(fn, floats, grad)
    _same(po, jo)
    if grad:
        _same(pg, jg)


# -- test_sequence_text.py's cases ------------------------------------------

@pytest.mark.parametrize("pkg", [J, P], ids=["jax", "port"])
def test_pad_unpad_roundtrip(pkg):
    seqs = [np.arange(3 * 2).reshape(3, 2).astype(np.float32),
            np.ones((1, 2), np.float32),
            np.full((2, 2), 7.0, np.float32)]
    padded, lens = pkg.nn.functional.sequence_pad(seqs, pad_value=0.0)
    assert padded.shape == [3, 3, 2]
    assert list(lens.numpy()) == [3, 1, 2]
    assert np.all(padded.numpy()[1, 1:] == 0)
    flat = pkg.nn.functional.sequence_unpad(padded, lens)
    assert np.allclose(flat.numpy(), np.concatenate(seqs, axis=0))


def test_pad_matches_jax():
    seqs = [_rand(n, 2, seed=n) for n in (3, 1, 4)]
    for args in (dict(pad_value=0.0), dict(pad_value=-1.0, maxlen=6)):
        jp = J.nn.functional.sequence_pad(seqs, **args)
        pp = P.nn.functional.sequence_pad(seqs, **args)
        _same([t.numpy() for t in pp], [t.numpy() for t in jp])
    flat = np.concatenate(seqs)
    lens = np.array([3, 1, 4], np.int64)
    jp = J.nn.functional.sequence_pad(J.to_tensor(flat), 2.0,
                                      lengths=J.to_tensor(lens))
    pp = P.nn.functional.sequence_pad(P.to_tensor(flat), 2.0,
                                      lengths=P.to_tensor(lens))
    _same([t.numpy() for t in pp], [t.numpy() for t in jp])
    with pytest.raises(ValueError, match="maxlen"):
        P.nn.functional.sequence_pad(seqs, 0.0, maxlen=2)
    with pytest.raises(ValueError, match="do not match"):
        P.nn.functional.sequence_pad(seqs, 0.0, lengths=[3, 1, 3])


def test_sequence_pool_types():
    x = np.array([[[1.0], [2.0], [3.0]],
                  [[4.0], [5.0], [0.0]]], np.float32)
    lens = np.array([3, 2], np.int64)
    F = P.nn.functional
    xp, lp = P.to_tensor(x), P.to_tensor(lens)
    assert np.allclose(F.sequence_pool(xp, "sum", lp).numpy(),
                       [[6.0], [9.0]])
    assert np.allclose(F.sequence_pool(xp, "average", lp).numpy(),
                       [[2.0], [4.5]])
    assert np.allclose(F.sequence_pool(xp, "max", lp).numpy(),
                       [[3.0], [5.0]])
    assert np.allclose(F.sequence_pool(xp, "sqrt", lp).numpy(),
                       [[6 / np.sqrt(3)], [9 / np.sqrt(2)]])
    assert np.allclose(F.sequence_pool(xp, "first", lp).numpy(),
                       [[1.0], [4.0]])
    assert np.allclose(F.sequence_pool(xp, "last", lp).numpy(),
                       [[3.0], [5.0]])


def test_sequence_pool_gradient_masks_padding():
    x = P.to_tensor(np.ones((2, 3, 1), np.float32))
    x.stop_gradient = False
    lens = P.to_tensor(np.array([3, 1], np.int64))
    P.nn.functional.sequence_pool(x, "sum", lens).sum().backward()
    g = x.grad.numpy()[:, :, 0]
    assert np.allclose(g, [[1, 1, 1], [1, 0, 0]])


def test_sequence_softmax_and_reverse():
    F = P.nn.functional
    x = np.array([[1.0, 2.0, 3.0], [1.0, 1.0, 9.0]], np.float32)
    lens = np.array([3, 2], np.int64)
    p = F.sequence_softmax(P.to_tensor(x), P.to_tensor(lens))
    assert np.allclose(p.numpy()[0], np.exp(x[0]) / np.exp(x[0]).sum(),
                       atol=1e-5)
    assert np.allclose(p.numpy()[1], [0.5, 0.5, 0.0])
    r = F.sequence_reverse(P.to_tensor(x[..., None]), P.to_tensor(lens))
    assert np.allclose(r.numpy()[0, :, 0], [3.0, 2.0, 1.0])
    assert np.allclose(r.numpy()[1, :, 0], [1.0, 1.0, 9.0])


def test_sequence_expand():
    out = P.nn.functional.sequence_expand(
        P.to_tensor(np.array([[1.0], [2.0]], np.float32)),
        P.to_tensor(np.array([2, 3], np.int64)))
    assert np.allclose(out.numpy()[:, 0], [1, 1, 2, 2, 2])


def test_edit_distance():
    F = P.nn.functional
    hyp = np.array([[ord(c) for c in "kitten "]], np.int64)
    ref = np.array([[ord(c) for c in "sitting"]], np.int64)
    kw = dict(input_length=P.to_tensor(np.array([6], np.int64)),
              label_length=P.to_tensor(np.array([7], np.int64)))
    d, n = F.edit_distance(P.to_tensor(hyp), P.to_tensor(ref),
                           normalized=False, **kw)
    assert d.numpy()[0, 0] == 3.0
    assert n.numpy()[0] == 1
    dn, _ = F.edit_distance(P.to_tensor(hyp), P.to_tensor(ref),
                            normalized=True, **kw)
    assert np.allclose(dn.numpy()[0, 0], 3.0 / 7.0)


def test_edit_distance_random_matches_jax():
    rs = np.random.RandomState(11)
    hyp = rs.randint(0, 4, (6, 9)).astype(np.int64)
    ref = rs.randint(0, 4, (6, 7)).astype(np.int64)
    hl = np.array([9, 0, 4, 7, 1, 3], np.int64)
    rl = np.array([7, 5, 0, 2, 7, 3], np.int64)
    for norm in (False, True):
        jd, jn = J.nn.functional.edit_distance(
            J.to_tensor(hyp), J.to_tensor(ref), normalized=norm,
            input_length=J.to_tensor(hl), label_length=J.to_tensor(rl))
        pd, pn = P.nn.functional.edit_distance(
            P.to_tensor(hyp), P.to_tensor(ref), normalized=norm,
            input_length=P.to_tensor(hl), label_length=P.to_tensor(rl))
        np.testing.assert_array_equal(pd.numpy(), jd.numpy())
        np.testing.assert_array_equal(pn.numpy(), jn.numpy())


def test_sequence_erase_matches_numpy():
    from paddle_tpu_torch.nn.functional.sequence import sequence_erase
    x = np.array([[2, 1, 3, 1, 5], [1, 1, 2, 0, 0]], np.int64)
    lens = np.array([5, 3], np.int64)
    out, new_len = sequence_erase(x, [1], lengths=lens)
    np.testing.assert_array_equal(new_len.numpy(), [3, 1])
    np.testing.assert_array_equal(out.numpy()[0, :3], [2, 3, 5])
    np.testing.assert_array_equal(out.numpy()[1, :1], [2])
    assert (out.numpy()[0, 3:] == 0).all()


def test_sequence_topk_avg_pooling_basic():
    from paddle_tpu_torch.nn.functional.sequence import \
        sequence_topk_avg_pooling
    x = np.random.RandomState(0).rand(2, 3, 4, 6).astype(np.float32)
    out = sequence_topk_avg_pooling(x, np.array([4, 2], np.int64),
                                    np.array([6, 3], np.int64),
                                    topks=[1, 3], channel_num=3)
    assert out.shape == [2, 4, 6]
    ref = np.sort(x[0, 1, 2])[::-1][:3].mean()
    np.testing.assert_allclose(out.numpy()[0, 2, 1 * 2 + 1], ref,
                               rtol=1e-5)
    assert (out.numpy()[1, 2:] == 0).all()


def test_torch_tensors_in_torch_out():
    x = torch.from_numpy(X)
    out = P.nn.functional.sequence_pool(x, "sum", torch.from_numpy(LENS))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(
        out.numpy(), P.nn.functional.sequence_pool(
            P.to_tensor(X), "sum", LENS).numpy())


# -- RaggedTensor routes and test_ragged.py's nested sequence_pad ----------

def _rows(seed=0, dim=3):
    rs = np.random.RandomState(seed)
    return [rs.rand(n, dim).astype(np.float32) for n in (1, 5, 0, 2)]


def _nested(seed=3, dim=2):
    rs = np.random.RandomState(seed)
    return [[rs.rand(3, dim).astype(np.float32),
             rs.rand(1, dim).astype(np.float32)],
            [rs.rand(2, dim).astype(np.float32)],
            [rs.rand(4, dim).astype(np.float32),
             rs.rand(2, dim).astype(np.float32),
             rs.rand(1, dim).astype(np.float32)]]


@pytest.mark.parametrize("how", ["sum", "mean", "max", "last", "softmax",
                                 "reverse", "pad"])
def test_ragged_routes_match_jax(how):
    rows = _rows()
    if how == "softmax":
        rows = [r[:, 0] for r in rows]
    outs = []
    for pkg, mod in ((J, JR), (P, PR)):
        rt = mod.RaggedTensor.from_rows(rows, capacity=10)
        F = pkg.nn.functional
        if how == "softmax":
            o = F.sequence_softmax(rt)
            outs.append([o.values.numpy()])
        elif how == "reverse":
            o = F.sequence_reverse(rt)
            outs.append([o.values.numpy()])
        elif how == "pad":
            outs.append([t.numpy() for t in F.sequence_pad(rt, -1.0)])
        else:
            outs.append([F.sequence_pool(rt, how, pad_value=3.0).numpy()])
    _same(outs[1], outs[0])


def test_ragged_expand_matches_jax():
    outs = []
    for mod, F in ((JR, J.nn.functional), (PR, P.nn.functional)):
        x = mod.RaggedTensor.from_rows(
            [np.array([[1.0], [2.0]], np.float32),
             np.array([[3.0]], np.float32)])
        ref = mod.RaggedTensor.from_rows(
            [np.zeros((2, 1), np.float32), np.zeros((3, 1), np.float32)])
        o = F.sequence_expand(x, ref)
        outs.append((o.lod(), [r for r in o.rows()]))
    assert outs[1][0] == [[int(v) for v in lvl] for lvl in outs[0][0]]
    _same(outs[1][1], outs[0][1])
    with pytest.raises(ValueError, match="RaggedTensor"):
        P.nn.functional.sequence_expand(
            PR.RaggedTensor.from_rows([np.zeros((1, 1), np.float32)]),
            np.array([2], np.int64))
    with pytest.raises(ValueError, match="row_splits"):
        P.nn.functional.sequence_pool(
            PR.RaggedTensor.from_rows([np.zeros((1, 1), np.float32)]),
            "sum", lengths=np.array([1]))


def test_sequence_pad_routes_nested():
    nested = _nested()
    got = []
    for pkg, mod in ((J, JR), (P, PR)):
        F = pkg.nn.functional
        rt = mod.RaggedTensor.from_nested_rows(nested)
        dense, row_lens = F.sequence_pad(rt, 0.0)
        assert list(dense.shape) == [3, 3, 4, 2]
        flat = mod.RaggedTensor.from_rows([r for g in nested for r in g])
        d1, l1 = F.sequence_pad(flat, 0.0)
        assert list(d1.shape) == [6, 4, 2]
        np.testing.assert_array_equal(l1.numpy(), [3, 1, 2, 4, 2, 1])
        got.append([dense.numpy(), row_lens.numpy(), d1.numpy(),
                    l1.numpy()])
    _same(got[1], got[0])


def test_sequence_pad_rejects_lod3():
    rs = np.random.RandomState(0)
    lvl3 = [[[rs.rand(2, 2).astype(np.float32)]],
            [[rs.rand(1, 2).astype(np.float32)]]]
    rt = PR.RaggedTensor.from_nested_rows(lvl3)
    with pytest.raises(ValueError, match="lod_level"):
        P.nn.functional.sequence_pad(rt, 0.0)
