"""py_func: run Python (numpy) code as an op — counterpart of
``paddle_tpu/ops/py_func.py``.

``py_func(func, x, out, backward_func, skip_vars_in_backward_input)``:
``func`` receives numpy copies of the inputs ``x`` and returns the
outputs, which must match the shapes and dtypes of the templates
``out``; ``backward_func`` receives the inputs, the outputs and the
output gradients (minus ``skip_vars_in_backward_input``) and returns
one gradient per input (None for no gradient).

The JAX package's host callback becomes a ``torch.autograd.Function``:
``forward`` calls ``func`` on numpy copies of the inputs and puts the
results on the inputs' device, ``backward`` calls ``backward_func``.
Integer and bool inputs get no gradient; integer outputs hand the
backward zeros of their dtype.  Without ``backward_func`` the outputs
carry no gradient.
"""
from __future__ import annotations

import numpy as np
import torch


def _spec_of(t):
    """(shape, numpy dtype) of a template handle or array."""
    from ..core.tensor import Tensor
    if isinstance(t, Tensor):
        t = t._data
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), torch.empty(
            0, dtype=t.dtype).numpy().dtype
    return tuple(int(d) for d in t.shape), np.dtype(t.dtype)


def _np(t):
    return t.detach().cpu().numpy()


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Run ``out = func(*x)`` on the host; see the module docstring."""
    from ..core.dispatch import ensure_tensor
    from ..core.tensor import Tensor

    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    single_out = not isinstance(out, (list, tuple))
    if not callable(func):
        raise TypeError("py_func: func must be callable")
    out_specs = [_spec_of(o) for o in outs]

    skip = skip_vars_in_backward_input
    skip = [] if skip is None else (
        list(skip) if isinstance(skip, (list, tuple)) else [skip])
    known = {id(v) for v in xs} | {id(v) for v in outs}
    for v in skip:
        if id(v) not in known:
            raise ValueError(
                "py_func: every skip_vars_in_backward_input entry must "
                "be one of x or out (reference fluid/layers/nn.py "
                "py_func checks the same)")
    skip_ids = {id(v) for v in skip}
    keep_x = [i for i, v in enumerate(xs) if id(v) not in skip_ids]
    keep_y = [i for i, v in enumerate(outs) if id(v) not in skip_ids]
    handles = [ensure_tensor(v) for v in xs]
    arrays = [h._data for h in handles]
    device = arrays[0].device if arrays else torch.device("cpu")

    def host_forward(*ts):
        res = func(*[_np(t) for t in ts])
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        if len(res) != len(out_specs):
            raise ValueError(
                f"py_func: func returned {len(res)} values, out "
                f"declares {len(out_specs)}")
        return tuple(
            torch.from_numpy(np.ascontiguousarray(
                np.asarray(r), dtype=d).reshape(s)).to(device)
            for r, (s, d) in zip(res, out_specs))

    if backward_func is None:
        with torch.no_grad():
            ys = host_forward(*arrays)
        res = [Tensor._wrap(y) for y in ys]
        return res[0] if single_out else res

    def host_backward(saved_x, ys, cts):
        n_x = len(saved_x)
        host_in = ([saved_x[i] for i in keep_x] + [ys[i] for i in keep_y]
                   + list(cts))
        gs = backward_func(*[_np(t) for t in host_in])
        gs = list(gs) if isinstance(gs, (list, tuple)) else [gs]
        if len(gs) != n_x:
            raise ValueError(
                f"py_func: backward_func returned {len(gs)} gradients "
                f"for {n_x} inputs")
        grads = []
        for a, g in zip(saved_x, gs):
            if not (a.is_floating_point() or a.is_complex()):
                grads.append(None)
            elif g is None:
                grads.append(torch.zeros_like(a))
            else:
                grads.append(torch.from_numpy(np.ascontiguousarray(
                    np.asarray(g), dtype=_np(a).dtype).reshape(
                        tuple(a.shape))).to(a.device))
        return tuple(grads)

    class _PyFunc(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *ts):
            ys = host_forward(*ts)
            ctx.save_for_backward(*ts, *ys)
            ctx.n_x = len(ts)
            ctx.mark_non_differentiable(*[
                y for y in ys if not y.is_floating_point()])
            return ys

        @staticmethod
        def backward(ctx, *cts):
            saved = ctx.saved_tensors
            xs_, ys = saved[:ctx.n_x], saved[ctx.n_x:]
            cts = [torch.zeros_like(y) if ct is None else ct
                   for ct, y in zip(cts, ys)]
            return host_backward(xs_, ys, cts)

    ys = _PyFunc.apply(*arrays)
    res = [Tensor._wrap(y) for y in ys]
    return res[0] if single_out else res
