"""Sparse embedding gradients and the sparse optimizer rules of the port
held to the JAX package's on the CPU: the cases of
``test_selected_rows.py`` (its ``test_jit_path_unaffected`` is JAX-only;
``nn.utils.clip_grad_norm_`` and ``legacy.merge_selected_rows`` wait
for slices 12b and 12f), 5 steps of every sparse optimizer, lazy and
not, against the JAX package's at rtol 1e-6, and the whole slice: a
two-layer MLP of the ported ops over a sparse embedding trained 5 steps
with lazy Adam in both packages (losses and parameters at rtol 1e-5).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import device as core_device
from paddle_tpu_torch.nn import functional as PF

torch.set_num_threads(1)

VOCAB, DIM = 64, 8


@pytest.fixture(autouse=True)
def _cpu():
    prev = core_device._current
    P.set_device("cpu")
    yield
    core_device._current = prev


def _w0(seed=0, vocab=VOCAB, dim=DIM):
    return np.random.RandomState(seed).randn(vocab, dim).astype(
        np.float32) * 0.5


def _ids(shape=(4, 6), seed=0, vocab=VOCAB):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int64)


def _param(pkg, w0):
    return (P.Parameter(w0) if pkg is P
            else J.core.tensor.Parameter(w0, name="emb"))


def _emb(pkg):
    return PF.embedding if pkg is P else JF.embedding


# ---- the representation -------------------------------------------------
def test_backward_produces_selected_rows():
    w = P.Parameter(_w0())
    PF.embedding(P.to_tensor(_ids()), w, sparse=True).sum().backward()
    g = w.grad
    assert isinstance(g, P.SelectedRows)
    assert list(g.values.shape) == [4 * 6, DIM]
    assert g.height == VOCAB and g.shape == [VOCAB, DIM]
    assert g.dtype == "float32" and not g.is_densified()
    assert w.torch().grad.is_sparse


@pytest.mark.parametrize("padding_idx", [None, 3, -2])
def test_matches_jax_and_dense_gradient(padding_idx):
    ids = _ids()
    ids[0, :3] = 3
    ids[1, 0] = VOCAB - 2
    grads = {}
    for pkg in (P, J):
        for sparse in (True, False):
            w = _param(pkg, _w0())
            out = _emb(pkg)(pkg.to_tensor(ids), w, padding_idx=padding_idx,
                            sparse=sparse)
            (out ** 2).sum().backward()
            grads[pkg.__name__, sparse] = w.grad.numpy()
    want = grads["paddle_tpu", True]
    for k, g in grads.items():
        np.testing.assert_allclose(g, want, rtol=1e-6, err_msg=str(k))
    if padding_idx is not None:
        np.testing.assert_array_equal(want[padding_idx % VOCAB],
                                      np.zeros(DIM))


def test_padding_rows_look_up_zero():
    for pkg in (P, J):
        w = _param(pkg, _w0())
        out = _emb(pkg)(pkg.to_tensor(np.array([[1, 3]])), w,
                        padding_idx=3, sparse=True)
        np.testing.assert_array_equal(out.numpy()[0, 1], np.zeros(DIM))


def test_accumulation_stays_sparse():
    w = P.Parameter(_w0())
    wd = P.Parameter(_w0())
    for seed in (1, 2):
        x = P.to_tensor(_ids(seed=seed))
        PF.embedding(x, w, sparse=True).sum().backward()
        PF.embedding(x, wd).sum().backward()
    g = w.grad
    assert isinstance(g, P.SelectedRows)
    assert list(g.values.shape) == [2 * 4 * 6, DIM]
    np.testing.assert_allclose(g.numpy(), wd.grad.numpy(), rtol=1e-6)


def test_merged_dedups():
    for cls in (P.SelectedRows, JSR):
        g = cls(np.array([2, 5, 2]),
                np.array([[1.0], [2.0], [3.0]], np.float32), 10)
        rows, vals = g.merged()
        np.testing.assert_array_equal(np.asarray(rows), [2, 5])
        np.testing.assert_allclose(np.asarray(vals), [[4.0], [2.0]])


def test_append_and_from_merged():
    a = P.SelectedRows(np.array([1, 2]), np.ones((2, 3), np.float32), 5)
    b = P.SelectedRows(np.array([2]), np.full((1, 3), 2.0, np.float32), 5)
    c = a.append(b)
    assert list(c.rows.shape) == [3]
    np.testing.assert_allclose(c.numpy()[2], [3, 3, 3])
    with pytest.raises(ValueError):
        a.append(P.SelectedRows(np.array([0]), np.ones((1, 2)), 5))
    m = P.SelectedRows.from_merged(np.array([0, 4]),
                                   np.ones((2, 3), np.float32), 5)
    assert m._merged_cache is not None
    np.testing.assert_array_equal(m.merged()[0].numpy(), [0, 4])
    with pytest.raises(ValueError, match="len\\(rows\\)"):
        P.SelectedRows(np.array([0, 1]), np.ones((3, 2)), 4)


# ---- the optimizers -----------------------------------------------------
OPTS = {
    "sgd": lambda O, ps: O.SGD(learning_rate=0.1, parameters=ps),
    "sgd_l2": lambda O, ps: O.SGD(learning_rate=0.1, weight_decay=0.01,
                                  parameters=ps),
    "momentum": lambda O, ps: O.Momentum(learning_rate=0.1, momentum=0.9,
                                         parameters=ps),
    "nesterov": lambda O, ps: O.Momentum(learning_rate=0.1, momentum=0.9,
                                         use_nesterov=True, parameters=ps),
    "adam": lambda O, ps: O.Adam(learning_rate=0.05, parameters=ps),
    "adam_lazy": lambda O, ps: O.Adam(learning_rate=0.05, parameters=ps,
                                      lazy_mode=True),
    "adam_l2_lazy": lambda O, ps: O.Adam(learning_rate=0.05,
                                         weight_decay=0.01, parameters=ps,
                                         lazy_mode=True),
    "adam_l2": lambda O, ps: O.Adam(learning_rate=0.05, weight_decay=0.01,
                                    parameters=ps),
    "adamw": lambda O, ps: O.AdamW(learning_rate=0.05, weight_decay=0.01,
                                   parameters=ps),
    "adamw_lazy": lambda O, ps: O.AdamW(learning_rate=0.05,
                                        weight_decay=0.01, parameters=ps,
                                        lazy_mode=True),
    "adamw_masked_lazy": lambda O, ps: O.AdamW(
        learning_rate=0.05, weight_decay=0.01, parameters=ps,
        lazy_mode=True, apply_decay_param_fun=lambda n: n != "emb"),
    "rmsprop_fallback": lambda O, ps: O.RMSProp(learning_rate=0.05,
                                                parameters=ps),
    "adagrad_fallback": lambda O, ps: O.Adagrad(learning_rate=0.05,
                                                parameters=ps),
}


def _train(pkg, name, sparse, steps=5, clip=None):
    O = popt if pkg is P else jopt
    w = _param(pkg, _w0())
    if pkg is P:
        w.name = "emb"
    opt = OPTS[name](O, [w])
    if clip is not None:
        opt._grad_clip = (popt.ClipGradByGlobalNorm(clip) if pkg is P
                          else J.nn.ClipGradByGlobalNorm(clip))
    for step in range(steps):
        out = _emb(pkg)(pkg.to_tensor(_ids(seed=step)), w, sparse=sparse)
        (out ** 2).sum().backward()
        opt.step()
        opt.clear_grad()
    return w.numpy()


@pytest.mark.parametrize("name", sorted(OPTS))
def test_sparse_optimizer_matches_jax(name):
    got = _train(P, name, sparse=True)
    want = _train(J, name, sparse=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam",
                                  "adamw", "rmsprop_fallback",
                                  "adagrad_fallback"])
def test_sparse_matches_dense_update(name):
    np.testing.assert_allclose(_train(P, name, sparse=True),
                               _train(P, name, sparse=False), rtol=2e-6,
                               atol=1e-7)


def test_lazy_adam_touches_only_rows():
    w = P.Parameter(_w0())
    w0 = w.numpy().copy()
    opt = popt.Adam(learning_rate=0.1, parameters=[w], lazy_mode=True)
    PF.embedding(P.to_tensor(np.array([[1, 2, 3]])), w,
                 sparse=True).sum().backward()
    opt.step()
    w1 = w.numpy()
    touched = [1, 2, 3]
    rest = [r for r in range(VOCAB) if r not in touched]
    assert (np.abs(w1[touched] - w0[touched]).max(axis=1) > 0).all()
    np.testing.assert_array_equal(w1[rest], w0[rest])
    m1 = opt.state[w.torch()]["moment1"].numpy()
    assert np.abs(m1[rest]).max() == 0


def test_lazy_mode_is_ignored_for_dense_gradients():
    a = _train(P, "adam_lazy", sparse=False)
    b = _train(P, "adam", sparse=False)
    np.testing.assert_array_equal(a, b)


def test_never_densified_through_a_clipped_step():
    w = P.Parameter(_w0())
    opt = popt.Adam(learning_rate=0.1, parameters=[w], lazy_mode=True,
                    grad_clip=popt.ClipGradByGlobalNorm(1.0))
    PF.embedding(P.to_tensor(_ids()), w, sparse=True).sum().backward()
    g = w.grad
    opt.step()
    opt.clear_grad()
    assert isinstance(g, P.SelectedRows) and not g.is_densified()


@pytest.mark.parametrize("name", ["sgd", "adam_lazy"])
def test_clip_matches_jax(name):
    np.testing.assert_allclose(_train(P, name, True, clip=0.01),
                               _train(J, name, True, clip=0.01),
                               rtol=1e-5, atol=1e-7)


def test_clip_matches_dense():
    np.testing.assert_allclose(_train(P, "sgd", True, steps=1, clip=0.01),
                               _train(P, "sgd", False, steps=1, clip=0.01),
                               rtol=1e-5)


# ---- dense mutation and shims -----------------------------------------
def test_data_setter_resyncs_sparse_view():
    g = P.SelectedRows(np.array([1, 1, 3]),
                       np.array([[1.0], [2.0], [4.0]], np.float32), 5)
    g._data = g._data * 0.5
    rows, vals = g.merged()
    dense = np.zeros((5, 1), np.float32)
    for r, v in zip(np.asarray(rows), np.asarray(vals)):
        dense[int(r)] = v
    np.testing.assert_allclose(dense[1], [1.5])
    np.testing.assert_allclose(dense[3], [2.0])
    assert g.is_densified()


def test_grad_scaler_unscale_applies_to_sparse_step():
    ws, wd = P.Parameter(_w0()), P.Parameter(_w0())
    opt_s = popt.SGD(learning_rate=0.1, parameters=[ws])
    opt_d = popt.SGD(learning_rate=0.1, parameters=[wd])
    scaler = pamp.GradScaler(init_loss_scaling=1024.0)
    x = P.to_tensor(_ids())
    loss = (PF.embedding(x, ws, sparse=True) ** 2).sum()
    P.Tensor._wrap(scaler.scale(loss.torch())).backward()
    scaler.step(opt_s)
    scaler.update()
    (PF.embedding(x, wd) ** 2).sum().backward()
    opt_d.step()
    np.testing.assert_allclose(ws.numpy(), wd.numpy(), rtol=1e-5)


def test_get_tensor_from_selected_rows():
    for pkg, cls in ((P, P.SelectedRows), (J, JSR)):
        g = cls(np.array([0, 2]),
                np.array([[1.0, 1.0], [2.0, 2.0]], np.float32), 4)
        t = pkg.get_tensor_from_selected_rows(g)
        assert not isinstance(t, cls) and t.shape == [4, 2]
        np.testing.assert_allclose(t.numpy()[2], [2.0, 2.0])
    x = P.to_tensor([1.0])
    assert P.get_tensor_from_selected_rows(x) is x


def test_create_graph_falls_back_dense():
    outs = []
    for pkg in (P, J):
        w = _param(pkg, _w0(vocab=8, dim=4))
        out = _emb(pkg)(pkg.to_tensor(np.array([[1, 2, 1]])), w,
                        sparse=True)
        (g,) = pkg.grad([(out ** 2).sum()], [w], create_graph=True)
        assert not isinstance(g, (P.SelectedRows, JSR))
        ((g ** 2).sum()).backward()
        outs.append(w.grad.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5)


# ---- the whole slice ----------------------------------------------------
def test_mlp_over_a_sparse_embedding_trains_like_jax():
    """ids -> sparse embedding -> mean over the sequence -> matmul + add
    -> tanh -> matmul + add -> mean squared error, written with the
    ported ops only, 5 steps of lazy Adam in both packages from the same
    numpy weights."""
    rs = np.random.RandomState(3)
    vals = {"emb": rs.randn(50, 16).astype(np.float32) * 0.3,
            "w1": rs.randn(16, 12).astype(np.float32) * 0.3,
            "b1": np.zeros(12, np.float32),
            "w2": rs.randn(12, 1).astype(np.float32) * 0.3,
            "b2": np.zeros(1, np.float32)}
    batches = [(rs.randint(0, 50, (6, 5)).astype(np.int64),
                rs.randn(6, 1).astype(np.float32)) for _ in range(5)]
    runs = {}
    for pkg in (P, J):
        ps = {k: (P.Parameter(v, name=k) if pkg is P else
                  J.core.tensor.Parameter(v, name=k))
              for k, v in vals.items()}
        O = popt if pkg is P else jopt
        opt = O.Adam(learning_rate=0.01, parameters=list(ps.values()),
                     lazy_mode=True)
        losses = []
        for ids, y in batches:
            e = _emb(pkg)(pkg.to_tensor(ids), ps["emb"], sparse=True)
            h = pkg.tanh(pkg.add(pkg.matmul(pkg.mean(e, axis=1), ps["w1"]),
                                 ps["b1"]))
            out = pkg.add(pkg.matmul(h, ps["w2"]), ps["b2"])
            loss = pkg.mean((out - pkg.to_tensor(y)) ** 2)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        runs[pkg.__name__] = (losses, {k: p.numpy() for k, p in ps.items()})
    (lp, pp), (lj, pj) = runs["paddle_tpu_torch"], runs["paddle_tpu"]
    np.testing.assert_allclose(lp, lj, rtol=1e-5)
    for k in vals:
        np.testing.assert_allclose(pp[k], pj[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert lp[-1] < lp[0]
