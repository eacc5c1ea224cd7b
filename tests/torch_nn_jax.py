"""The JAX package's side of the ``nn`` parity tests: each case of
``tests/torch_nn_cases.py`` through ``paddle_tpu``, traced whole and
compiled once by ``jax.jit`` — one compile a case in place of the
eager path's one a primitive, which would not fit the tests' time.

``reference(case, grad)`` gives the outputs and, with ``grad``, the
gradients of ``sum(out_k * w_k)`` (``torch_nn_cases.grad_weights``) with
respect to the float inputs and a layer case's parameters, in
``torch_nn_cases.run_case``'s order, by ``jax.value_and_grad`` of the
traced case.  A layer case's parameters enter the program as inputs:
``torch_nn_cases.load`` sets them from the seeded values through
``STATE_HOOK``.  Random draws inside the trace fold into a fixed key
(the package's ``rng.push_trace_key``, as its compiled training step
does).  As in the eager path, only outputs that carry a gradient
(``stop_gradient`` false) enter the loss.

Where the eager JAX path gives an input no gradient because the op
closes over it as a constant, the traced program would differentiate
through it; ``CONSTANT_INPUTS`` names those inputs, and the program
stops their gradient:

* ``F.binary_cross_entropy_with_logits``'s ``pos_weight`` (input 2):
  ``paddle_tpu``'s ``binary_cross_entropy_with_logits`` reads it as a
  constant of its primitive.

A case whose JAX code reads a traced value on the host cannot be
traced; it runs eagerly instead.  Results are kept per case, so a
file's forward and gradient tests compile a case once.
"""
import jax
import numpy as np

import paddle_tpu as J
from paddle_tpu.core import rng

import torch_nn_cases as C

CONSTANT_INPUTS = {"F.binary_cross_entropy_with_logits": (2,)}

_cache = {}


def _traced(case, grad):
    cid, fn, inputs, _, _, _ = case
    fl = [k for k, a in enumerate(inputs) if a.dtype.kind == "f"]
    const = CONSTANT_INPUTS.get(cid, ())
    shapes = []

    def record(layer, state):
        for name, t in layer.state_dict().items():
            t._data = jax.numpy.asarray(state[name], t._data.dtype)
        shapes[:] = [(tuple(p._data.shape), p._data.dtype)
                     for p in layer.parameters()]

    def run(floats, deltas):
        arrays = list(inputs)
        for k, a in zip(fl, floats):
            arrays[k] = jax.lax.stop_gradient(a) if k in const else a
        ts = [J.Tensor(a, stop_gradient=not grad or k not in fl)
              for k, a in enumerate(arrays)]

        def hook(layer, state):
            record(layer, state)
            for p, d in zip(layer.parameters(), deltas):
                p._data = p._data + d

        C.STATE_HOOK[0] = hook
        rng.push_trace_key(jax.random.key(0))
        try:
            outs = C.flat(fn(J, *ts))
        finally:
            C.STATE_HOOK[0] = None
            rng.pop_trace_key()
        loss = 0.0
        for k, o in enumerate(outs):
            if not o.stop_gradient and o._data.dtype.kind == "f":
                loss = loss + (o._data * C.grad_weights(o.shape, k)).sum()
        return loss, [o._data for o in outs]

    floats = [inputs[k] for k in fl]
    if not grad:
        outs = jax.jit(lambda f: run(f, [])[1])(floats)
        return [np.asarray(o) for o in outs], None
    # the parameters' shapes, from a trace that compiles nothing
    jax.eval_shape(lambda f: run(f, []), floats)
    deltas = [np.zeros(s, d) for s, d in shapes]
    (_, outs), (g_in, g_par) = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(floats, deltas)
    grads = [None] * len(inputs)
    for k, g in zip(fl, g_in):
        grads[k] = np.asarray(g)
    return ([np.asarray(o) for o in outs],
            grads + [np.asarray(g) for g in g_par])


def reference(case, grad):
    """``(outputs, gradients or None)`` of ``case`` through the JAX
    package (module docstring)."""
    key = (case[0], grad)
    if key not in _cache:
        try:
            _cache[key] = _traced(case, grad)
        except jax.errors.JAXTypeError:
            _cache[key] = C.run_case(J, case, grad)
    return _cache[key]
