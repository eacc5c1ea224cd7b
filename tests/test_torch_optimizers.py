"""The port's optimizers held to the JAX package's eager optimizers.

* Every rule of ``paddle_tpu/optimizer/__init__.py`` beyond Adam/AdamW
  (``SGD``, ``Momentum`` plain and nesterov, ``Adamax``, ``Adagrad``,
  ``RMSProp`` plain and centered, ``Adadelta``, ``Lamb``,
  ``LarsMomentum``) and of ``extras.py`` (``DecayedAdagrad``, ``Ftrl``,
  ``Dpsgd`` at sigma 0), plus ``Adam(multi_precision=False)`` and
  ``AdamW(lr_ratio=...)``: 5 eager steps over the same gradients.  fp32
  parameters and states agree at rtol 1e-6 / atol 1e-7 (the same
  elementwise formulas; XLA may fuse them with other roundings); bf16
  parameters at rtol 1e-2 / atol 1e-2 (a few bf16 roundings of values of
  order 1 over 5 steps).  ``LarsMomentum`` runs fp32 only: the JAX rule
  turns a bf16 parameter into f32 (its f32 local rate promotes the
  velocity and the parameter), which the port does not copy.
* ``Adam(multi_precision=False)`` keeps bf16 moments, the default f32.
* ``Lamb``'s ``exclude_from_weight_decay_fn`` gets the parameter in
  ``step()`` and the name under the compiled-step form; a parameter's
  ``optimize_attr["learning_rate"]`` scales its rate in ``step()`` only.
* ``Dpsgd``'s noise: the same seed repeats it, another seed changes it,
  and its mean and standard deviation match N(0, sigma*clip/batch).
* ``ExponentialMovingAverage``, ``ModelAverage`` and
  ``LookaheadOptimizer`` against the JAX package's (fp32, rtol 1e-6).
* State dicts: the JAX format both ways through ``convert`` (a run begun
  in one package continues in the other), and torch's format keeping
  f32 moments of bf16 parameters.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.optimizer import extras as jext
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import extras as text

torch.set_num_threads(1)

SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "emb.weight": (4, 3)}
STEPS = 5
# name -> (class name, kwargs); both packages take the same keywords
CASES = {
    "SGD": ("SGD", dict(learning_rate=0.05, weight_decay=0.01)),
    "Momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=0.01)),
    "Momentum_nesterov": ("Momentum", dict(learning_rate=0.05,
                                           momentum=0.9,
                                           use_nesterov=True)),
    "Adamax": ("Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    "Adagrad": ("Adagrad", dict(learning_rate=0.1, weight_decay=0.01,
                                initial_accumulator_value=0.1)),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                weight_decay=0.01)),
    "RMSProp_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True)),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0, weight_decay=0.01)),
    "Lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.05)),
    "LarsMomentum": ("LarsMomentum", dict(learning_rate=0.1,
                                          momentum=0.9)),
    "DecayedAdagrad": ("DecayedAdagrad", dict(learning_rate=0.1,
                                              weight_decay=0.01)),
    "Ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.01, l2=0.01)),
    "Dpsgd": ("Dpsgd", dict(learning_rate=0.1, clip=1.0, batch_size=4.0,
                            sigma=0.0)),
    "Adam_no_multi_precision": ("Adam", dict(learning_rate=0.01,
                                             multi_precision=False,
                                             lazy_mode=True)),
    "AdamW_lr_ratio": ("AdamW", dict(learning_rate=0.01, weight_decay=0.1,
                                     lr_ratio=lambda p: 0.5)),
}
TOL = {"float32": dict(rtol=1e-6, atol=1e-7),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _jax_class(name):
    return getattr(jopt, name, None) or getattr(jext, name)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    init = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(STEPS)]
    return init, grads


def _jax_run(cls_name, kw, init, grads, dtype):
    import jax.numpy as jnp
    params = {n: JParam(jnp.asarray(a).astype(getattr(jnp, dtype)))
              for n, a in init.items()}
    opt = _jax_class(cls_name)(parameters=list(params.values()), **kw)
    for g in grads:
        for n, p in params.items():
            p.grad = paddle.to_tensor(g[n])
        opt.step()
    return params, opt


def _torch_run(cls_name, kw, init, grads, dtype, **extra):
    params = {n: torch.nn.Parameter(torch.tensor(a).to(getattr(torch,
                                                               dtype)))
              for n, a in init.items()}
    opt = getattr(topt, cls_name)(parameters=list(params.items()),
                                  device="cpu", **kw, **extra)
    for g in grads:
        for n, p in params.items():
            p.grad = torch.tensor(g[n]).to(p.dtype)
        opt.step()
    return params, opt


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(getattr(x, "_data", x)).astype(
        jnp.float32))


PARAMS = [(c, d) for c in CASES for d in ("float32", "bfloat16")
          if not (c == "LarsMomentum" and d == "bfloat16")]


@pytest.mark.parametrize("case,dtype", PARAMS,
                         ids=[f"{c}-{d}" for c, d in PARAMS])
def test_optimizer_matches_jax(case, dtype):
    cls_name, kw = CASES[case]
    init, grads = _data()
    jp, jo = _jax_run(cls_name, kw, init, grads, dtype)
    tp, to = _torch_run(cls_name, kw, init, grads, dtype)
    tol = TOL[dtype]
    for n in SHAPES:
        assert tp[n].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_f32(tp[n]), _f32(jp[n]),
                                   err_msg=n, **tol)
        js = jo._accumulators[id(jp[n])]
        ts = to.state[tp[n]]
        assert sorted(ts) == sorted(js), n
        for key in js:
            np.testing.assert_allclose(_f32(ts[key]), _f32(js[key]),
                                       err_msg=f"{n} {key}", **tol)
    assert to._step_count == jo._step_count == STEPS


@pytest.mark.parametrize("multi_precision,want", [(True, torch.float32),
                                                  (False, torch.bfloat16)])
def test_adam_multi_precision_moment_dtypes(multi_precision, want):
    init, grads = _data(1)
    for cls in ("Adam", "AdamW"):
        tp, to = _torch_run(cls, dict(multi_precision=multi_precision),
                            init, grads[:1], "bfloat16")
        for p in tp.values():
            st = to.state[p]
            assert st["moment1"].dtype == st["moment2"].dtype == want
            assert st["beta1_pow"].dtype == torch.float32
            assert p.dtype == torch.bfloat16


def test_lamb_exclude_fn_gets_the_parameter():
    """The predicate sees parameters in ``step()``: excluding the 1-D ones
    matches the JAX package (fp32, rtol 1e-6), and an excluded parameter
    moves as it does with no decay at all."""
    init, grads = _data(2)
    kw = dict(learning_rate=0.01, lamb_weight_decay=0.1,
              exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1)
    seen = []
    jp, _ = _jax_run("Lamb", kw, init, grads, "float32")
    tp, _ = _torch_run("Lamb", dict(kw, exclude_from_weight_decay_fn=(
        lambda p: seen.append(p) or p.dim() == 1)), init, grads, "float32")
    assert all(isinstance(p, torch.nn.Parameter) for p in seen)
    for n in SHAPES:
        np.testing.assert_allclose(_f32(tp[n]), _f32(jp[n]), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    free, _ = _torch_run("Lamb", dict(learning_rate=0.01,
                                      lamb_weight_decay=0.0),
                         init, grads, "float32")
    torch.testing.assert_close(tp["fc.bias"], free["fc.bias"], rtol=0,
                               atol=0)
    assert not torch.equal(tp["fc.weight"], free["fc.weight"])


def test_per_parameter_rate_multiplier():
    """``optimize_attr["learning_rate"]`` scales a parameter's rate in
    ``step()`` as in the JAX eager step (rtol 1e-6); the compiled-step
    form (``apply_gradients``) uses the one rate, as JAX's tree update."""
    init, grads = _data(5)
    import jax.numpy as jnp
    jp = {n: JParam(jnp.asarray(a)) for n, a in init.items()}
    jp["fc.bias"].optimize_attr = {"learning_rate": 0.25}
    jo = jopt.SGD(learning_rate=0.1, parameters=list(jp.values()))
    tp = {n: torch.nn.Parameter(torch.tensor(a)) for n, a in init.items()}
    tp["fc.bias"].optimize_attr = {"learning_rate": 0.25}
    to = topt.SGD(learning_rate=0.1, parameters=list(tp.values()),
                  device="cpu")
    for n in SHAPES:
        jp[n].grad = paddle.to_tensor(grads[0][n])
        tp[n].grad = torch.tensor(grads[0][n])
    jo.step()
    to.step()
    for n in SHAPES:
        np.testing.assert_allclose(_f32(tp[n]), _f32(jp[n]), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    before = tp["fc.bias"].detach().clone()
    to.apply_gradients()
    torch.testing.assert_close(tp["fc.bias"].detach(),
                               before - 0.1 * tp["fc.bias"].grad,
                               rtol=1e-6, atol=1e-7)


def test_lamb_compiled_form_passes_names():
    """``apply_gradients`` (the TrainStep form) hands the predicate the
    parameter's name, as the JAX package's tree update does."""
    names = []
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.Lamb(parameters=[("ln.bias", p)], device="cpu",
                    exclude_from_weight_decay_fn=lambda n: names.append(n)
                    or "bias" in n)
    p.grad = torch.ones(3)
    opt.apply_gradients()
    assert names == ["ln.bias"]


def test_dpsgd_seed_contract_and_noise_moments():
    """With zero gradients and lr 1 a step moves a parameter by minus its
    noise: the same seed gives the same noise, another seed other noise;
    over 200k elements the mean is within 5 standard errors of 0 and the
    standard deviation within 2% of sigma*clip/batch (= 0.5)."""
    n = 200_000

    def noise(seed, steps=1):
        p = torch.nn.Parameter(torch.zeros(n))
        opt = text.Dpsgd(learning_rate=1.0, clip=2.0, batch_size=4.0,
                         sigma=1.0, seed=seed, parameters=[p],
                         device="cpu")
        out = []
        for _ in range(steps):
            before = p.detach().clone()
            p.grad = torch.zeros(n)
            opt.step()
            out.append(before - p.detach())
        return out, opt

    a, opt = noise(3, steps=2)
    b, _ = noise(3, steps=2)
    c, _ = noise(4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], c[0])
    assert int(opt.state[opt._params()[0]]["t"]) == 2
    sd = 0.5
    for x in a + c:
        assert abs(float(x.mean())) < 5 * sd / n ** 0.5
        assert abs(float(x.std()) / sd - 1) < 0.02


def _averaging_pair(kind):
    init, grads = _data(3)
    jp = {n: JParam(paddle.to_tensor(a)._data) for n, a in init.items()}
    tp = {n: torch.nn.Parameter(torch.tensor(a)) for n, a in init.items()}
    jo = jopt.SGD(learning_rate=0.1, parameters=list(jp.values()))
    to = topt.SGD(learning_rate=0.1, parameters=list(tp.values()),
                  device="cpu")
    if kind == "ema":
        ja, ta = jext.ExponentialMovingAverage(0.9), \
            text.ExponentialMovingAverage(0.9)
    elif kind == "model_average":
        ja = jext.ModelAverage(0.5, min_average_window=3,
                               max_average_window=4,
                               parameters=list(jp.values()))
        ta = text.ModelAverage(0.5, min_average_window=3,
                               max_average_window=4,
                               parameters=list(tp.values()))
    else:
        jo = jext.LookaheadOptimizer(jo, alpha=0.5, k=2)
        to = text.LookaheadOptimizer(to, alpha=0.5, k=2)
        ja = ta = None
    for g in grads:
        for n in SHAPES:
            jp[n].grad = paddle.to_tensor(g[n])
            tp[n].grad = torch.tensor(g[n])
        jo.step()
        to.step()
        if kind == "ema":
            ja.update(list(jp.values()))
            ta.update(list(tp.values()))
        elif kind == "model_average":
            ja.update()
            ta.update()
    return jp, tp, ja, ta


@pytest.mark.parametrize("kind", ["ema", "model_average", "lookahead"])
def test_averaging_utilities_match_jax(kind):
    """The averaged weights inside ``apply()`` and the restored weights
    after it (or Lookahead's slow/fast weights) agree at rtol 1e-6."""
    jp, tp, ja, ta = _averaging_pair(kind)

    def same():
        for n in SHAPES:
            np.testing.assert_allclose(_f32(tp[n]), _f32(jp[n]),
                                       rtol=1e-6, atol=1e-7, err_msg=n)

    same()
    if ja is None:
        return
    before = {n: tp[n].detach().clone() for n in SHAPES}
    with ja.apply(), ta.apply():
        same()
        assert not torch.equal(tp["fc.weight"], before["fc.weight"])
    same()
    for n in SHAPES:
        assert torch.equal(tp[n], before[n])


def _model_pair(seed):
    """The tiny port GPT's parameters, JAX parameters holding the same
    values in ``paddle_tpu``'s layout, and 3 steps of gradients (JAX
    layout; linear weights' transposed for the port)."""
    import jax.numpy as jnp
    from paddle_tpu_torch.convert import export_paddle_tpu_state
    from paddle_tpu_torch.models import GPTModel
    tm = GPTModel.from_config("tiny", device="cpu", seed=seed)
    arrays = export_paddle_tpu_state(tm)
    jp = {n: JParam(jnp.asarray(a)) for n, a in arrays.items()}
    rng = np.random.RandomState(seed)
    grads = [{n: rng.randn(*a.shape).astype(np.float32)
              for n, a in arrays.items()} for _ in range(3)]
    return tm, jp, grads


def _flipped(tm, n, a):
    """``a`` in the port's layout for parameter ``n``."""
    return a.T if a.ndim == 2 and "embeddings" not in n else a


def _jax_step(jp, opt, g):
    for n, p in jp.items():
        p.grad = paddle.to_tensor(g[n])
    opt.step()


def _torch_step(tm, opt, g):
    for n, p in tm.named_parameters():
        p.grad = torch.tensor(_flipped(tm, n, g[n]))
    opt.step()


def _close_models(jp, tm):
    from paddle_tpu_torch.convert import export_paddle_tpu_state
    ours = export_paddle_tpu_state(tm)
    for n, p in jp.items():
        np.testing.assert_allclose(ours[n], np.asarray(p._data), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def _sched(mod):
    return mod.lr.LinearWarmup(mod.lr.CosineAnnealingDecay(1e-2, 10), 2,
                               0.0, 1e-2)


def test_state_dict_jax_to_port():
    """AdamW state after 2 JAX steps (a scheduler's included) loads into
    the port: names through the JAX parameters' ``.name``, the moments of
    linear weights transposed.  A third step in each package leaves the
    weights equal at rtol 1e-6 (fp32), the schedules and counters
    equal."""
    from paddle_tpu_torch.convert import load_optimizer_state
    tm, jp, grads = _model_pair(21)
    jo = jopt.AdamW(learning_rate=_sched(jopt),
                    parameters=list(jp.values()))
    for g in grads[:2]:
        _jax_step(jp, jo, g)
        jo._learning_rate.step()
    with torch.no_grad():
        for n, p in tm.named_parameters():
            p.copy_(torch.tensor(_flipped(tm, n, np.asarray(jp[n]._data))))
    to = topt.AdamW(learning_rate=_sched(topt),
                    parameters=tm.named_parameters(), device="cpu")
    load_optimizer_state(to, tm, jo.state_dict(),
                         names={n: p.name for n, p in jp.items()})
    assert to._step_count == 2 and to.get_lr() == jo.get_lr()
    _jax_step(jp, jo, grads[2])
    _torch_step(tm, to, grads[2])
    _close_models(jp, tm)
    st = to.state[tm.embeddings.word_embeddings.weight]
    assert float(st["beta1_pow"]) == pytest.approx(0.9 ** 3, rel=1e-6)


def test_state_dict_port_to_jax():
    """The reverse: the port's state after 2 steps, exported as numpy in
    the JAX format, equals what the JAX optimizer holds once it loads it
    (exactly), and a third step in each stays equal at rtol 1e-6."""
    from paddle_tpu_torch.convert import (export_optimizer_state,
                                          export_paddle_tpu_state)
    tm, jp, grads = _model_pair(22)
    to = topt.AdamW(learning_rate=_sched(topt),
                    parameters=tm.named_parameters(), device="cpu")
    for g in grads[:2]:
        _torch_step(tm, to, g)
        to._learning_rate.step()
    ours = export_paddle_tpu_state(tm)
    for n, p in jp.items():
        p._data = paddle.to_tensor(ours[n])._data
    names = {n: p.name for n, p in jp.items()}
    state = export_optimizer_state(to, tm, names=names)
    assert state["__step__"] == 2 and "LR_Scheduler" in state
    jo = jopt.AdamW(learning_rate=_sched(jopt),
                    parameters=list(jp.values()))
    jo.set_state_dict(state)
    for n, p in jp.items():
        for key in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_array_equal(
                np.asarray(jo._accumulators[id(p)][key]),
                state[f"{names[n]}__{key}"], err_msg=f"{n} {key}")
    assert jo.get_lr() == to.get_lr()
    _jax_step(jp, jo, grads[2])
    _torch_step(tm, to, grads[2])
    _close_models(jp, tm)


def test_torch_state_dict_keeps_moment_dtypes():
    """torch's format round trips (``load_state_dict`` and
    ``set_state_dict``) keep f32 moments of bf16 parameters, and the
    port's own JAX-format dict loads back exactly."""
    init, grads = _data(4)
    tp, to = _torch_run("AdamW", {}, init, grads, "bfloat16")
    sd = to.state_dict()
    paddle_sd = to.paddle_state_dict()
    assert set(paddle_sd) == {"__step__"} | {
        f"{n}__{k}" for n in SHAPES
        for k in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
    for how in ("load_state_dict", "set_state_dict", "paddle"):
        fresh = {n: torch.nn.Parameter(p.detach().clone())
                 for n, p in tp.items()}
        opt = topt.AdamW(parameters=list(fresh.items()), device="cpu")
        if how == "paddle":
            opt.set_state_dict(paddle_sd)
        else:
            getattr(opt, how)(sd)
        for n in SHAPES:
            for k, v in to.state[tp[n]].items():
                got = opt.state[fresh[n]][k]
                assert got.dtype == v.dtype, (how, n, k)
                assert torch.equal(got, v), (how, n, k)
        assert opt._step_count == (STEPS if how == "paddle" else 0)
