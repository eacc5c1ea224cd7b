"""Sparse embedding training checks of the port, shared by
``tests/test_torch_sparse_train.py`` (a small table, on the CPU and,
marked ``cuda``, on the card) and ``chip_smoke.py`` phase 24 (b)
(gpt2-medium's token table on the card).  Imports numpy and the port
only.

Each run trains ``w [vocab, dim]`` (normal, std 0.02, numpy seed 0)
for ``STEPS`` steps of ``embedding(ids, w, sparse=...)``, a squared-sum
loss, ``backward`` and ``step``, on ids ``[batch, seq]`` from numpy seed
0.  ``check_all`` holds:

1. SGD, Momentum and ``Adam(lazy_mode=False)`` on the sparse gradient
   equal the same optimizer on the dense gradient (rtol 1e-6);
2. lazy Adam and lazy AdamW leave every untouched row of the weight and
   of both moments bit-identical to the start;
3. lazy Adam's touched rows (weights and moments) equal the rule
   computed row by row in float32 numpy on the host (rtol 1e-6, atol
   1e-7).
"""
from __future__ import annotations

import numpy as np

OPTIMIZERS = {
    "sgd": lambda O, ps: O.SGD(learning_rate=0.1, parameters=ps),
    "momentum": lambda O, ps: O.Momentum(learning_rate=0.1, momentum=0.9,
                                         parameters=ps),
    "adam": lambda O, ps: O.Adam(learning_rate=1e-3, parameters=ps),
    "adam_lazy": lambda O, ps: O.Adam(learning_rate=1e-3, parameters=ps,
                                      lazy_mode=True),
    "adamw_lazy": lambda O, ps: O.AdamW(learning_rate=1e-3,
                                        weight_decay=0.01, parameters=ps,
                                        lazy_mode=True),
}
DENSE_TWINS = ("sgd", "momentum", "adam")
STEPS = 3            # the checked steps of every run
TIMED_STEPS = 10     # a timed run's steps after its warm-up step


def make_inputs(vocab, dim, batch, seq):
    rs = np.random.RandomState(0)
    w0 = (rs.randn(vocab, dim) * 0.02).astype(np.float32)
    ids = np.random.RandomState(0).randint(0, vocab, (batch, seq)).astype(
        np.int64)
    return w0, ids


def train(P, name, w0, ids, sparse, steps, timer=None):
    """One run on the current place: ``(weight, optimizer state, ms a
    step or None, the last gradient's value bytes)``."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import functional as F
    w = P.Parameter(w0)
    opt = OPTIMIZERS[name](O, [w])
    x = P.to_tensor(ids)
    grad_bytes = []

    def step():
        out = F.embedding(x, w, sparse=sparse)
        (out * out).sum().backward()
        g = w.grad
        grad_bytes.append(
            int(g.values.numel() * g.values.element_size())
            if isinstance(g, P.SelectedRows) else
            int(g.torch().numel() * g.torch().element_size()))
        opt.step()
        opt.clear_grad()

    ms = []
    for _ in range(steps):
        if timer is None:
            step()
        else:
            ms.append(timer(step))
    state = opt.state[w.torch()]
    # the first step pays the lazy allocations: the median of the others
    ms = float(np.median(ms[1:] or ms)) if ms else None
    return w, state, ms, grad_bytes[-1]


def lazy_adam_reference(w0, ids, steps, lr=1e-3, b1=0.9, b2=0.999,
                        eps=1e-8):
    """Lazy Adam on the rows ``ids`` touch, in float32 numpy on the host,
    each row by the rule's own elementwise formulas (the rows batched):
    ``(rows, their weights, moment1, moment2)`` after ``steps`` steps."""
    f = np.float32
    rows, counts = np.unique(ids, return_counts=True)
    p = w0[rows].copy()
    m = np.zeros_like(p)
    v = np.zeros_like(p)
    c = counts.astype(np.float32)[:, None]
    b1p = b2p = f(1.0)
    for _ in range(steps):
        b1p = f(b1p * f(b1))
        b2p = f(b2p * f(b2))
        g = f(2.0) * c * p
        m = f(b1) * m + f(1 - b1) * g
        v = f(b2) * v + f(1 - b2) * (g * g)
        upd = (m / f(1 - b1p)) / (np.sqrt(v / f(1 - b2p)) + f(eps))
        p = p - f(lr) * upd
    return rows, p, m, v


def check_all(P, vocab, dim, batch, seq, timer=None):
    """Run the five optimizers sparse (and the dense twins dense), hold
    the three checks; returns a dict of results per run.  Raises
    ``AssertionError`` naming the check that failed.  With ``timer``
    (``timer(fn)`` -> ms of one call) each run is repeated for
    ``1 + TIMED_STEPS`` steps, and ``ms`` is the median of all but the
    first."""
    w0, ids = make_inputs(vocab, dim, batch, seq)
    touched = np.zeros(vocab, bool)
    touched[np.unique(ids)] = True
    res = {}
    def timed(name, sparse):
        if timer is None:
            return None
        return train(P, name, w0, ids, sparse, 1 + TIMED_STEPS, timer)[2]

    for name in OPTIMIZERS:
        w, state, _, gbytes = train(P, name, w0, ids, True, STEPS)
        got = w.numpy()
        out = {"ms": timed(name, True), "grad_bytes": gbytes}
        if name in DENSE_TWINS:
            wd, _, _, gbytes_d = train(P, name, w0, ids, False, STEPS)
            ms_d = timed(name, False)
            want = wd.numpy()
            err = float(np.max(np.abs(got - want)
                               / np.maximum(np.abs(want), 1e-30)))
            out.update(dense_ms=ms_d, dense_grad_bytes=gbytes_d,
                       max_rel_vs_dense=err)
            np.testing.assert_allclose(
                got, want, rtol=1e-6, atol=0,
                err_msg=f"check 1: {name} sparse vs dense")
        if name.endswith("_lazy"):
            m1 = state["moment1"].detach().cpu().numpy()
            m2 = state["moment2"].detach().cpu().numpy()
            still = ~touched
            assert np.array_equal(got[still], w0[still]), \
                f"check 2: {name} moved an untouched row"
            assert not m1[still].any() and not m2[still].any(), \
                f"check 2: {name} moved an untouched moment"
            out["untouched_rows"] = int(still.sum())
        if name == "adam_lazy":
            rows, p, m, v = lazy_adam_reference(w0, ids, STEPS)
            for label, a, b in (("weights", got[rows], p),
                                ("moment1", m1[rows], m),
                                ("moment2", m2[rows], v)):
                np.testing.assert_allclose(
                    a, b, rtol=1e-6, atol=1e-7,
                    err_msg=f"check 3: lazy Adam's touched {label}")
            out["max_abs_vs_rows"] = float(np.max(np.abs(got[rows] - p)))
        res[name] = out
    return res
