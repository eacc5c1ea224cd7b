"""The port's training path held to the JAX package's.

* Attention dropout drops the attention OUTPUT (before ``out_proj``), as
  ``paddle_tpu``'s ``scaled_dot_product_attention`` does, on both the
  reference and the flash route.
* ``cross_entropy`` and ``fused_linear_cross_entropy``: value and
  gradients against the JAX functions (fp32, rtol 1e-5 / atol 1e-6: the
  chunked log-sum-exp and the matmuls sum in another order).
* ``Adam`` / ``AdamW`` (weight decay, ``apply_decay_param_fun``,
  ``ClipGradByGlobalNorm``): three updates on fp32 and bf16 tensors
  against the JAX optimizer's ``apply_gradients_tree``.  fp32 parameters
  at rtol 1e-6 / atol 1e-7 (the same elementwise formula; XLA may fuse
  it with other roundings); bf16 parameters at one bf16 step of their
  value (rtol 2**-7); f32 moments at rtol 1e-6 / atol 1e-8 (the clip's
  global norm sums in another order, a last-bit change of the scale).
* The slice as a whole: a 2-layer GPT (hidden 128, 2 heads of 64, vocab
  128) at S=128 with ``FLASH_MIN_SEQ`` lowered to 128, so attention runs
  the flash op's plain version and its hand-written backward.  Both
  packages start from the same weights, with dropout 0, the fused loss
  and AdamW, and take 3 ``TrainStep.step`` calls: losses agree to rtol
  1e-4.  Parameters (``export_paddle_tpu_state``) agree to atol 2e-6 on
  all but 0.1% of their elements, and to atol 2e-4 on every element:
  Adam divides each gradient by its own magnitude, so where a gradient
  is near zero the two frameworks' float-order differences move the
  update by up to a step of lr 1e-3, and 2e-4 is a fifth of one.
* Knobs the port does not carry raise ``NotImplementedError`` naming
  their ROADMAP item (the serving half of the mesh's, ``metrics=`` and
  the multi-process helpers); the mesh knobs train.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.fleet.strategy import \
    DistributedStrategy as JaxStrategy
from paddle_tpu.models import GPTModel as JaxGPT
from paddle_tpu.nn import functional as JF
from paddle_tpu.parallel.train_step import TrainStep as JaxTrainStep
from paddle_tpu_torch.convert import (export_paddle_tpu_state,
                                      load_paddle_tpu_state)
from paddle_tpu_torch.distributed import MoELayer
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.models import GPTAttention, GPTModel
from paddle_tpu_torch.nn.functional import attention as attn_mod
from paddle_tpu_torch.nn.functional import (cross_entropy,
                                            fused_linear_cross_entropy)
from paddle_tpu_torch.optimizer import Adam, AdamW, ClipGradByGlobalNorm
from paddle_tpu_torch.parallel import TrainStep

torch.set_num_threads(1)


# -- attention dropout ----------------------------------------------------
@pytest.mark.parametrize("route", ["reference", "flash"])
def test_attention_dropout_drops_the_output(monkeypatch, route):
    """In train mode with p=0.5, every element of out_proj's input is 0
    or twice its eval-mode value (atol 1e-6): the softmax itself is
    undropped.  About half the elements are dropped."""
    S = 16
    if route == "flash":
        S = 128
        monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    torch.manual_seed(0)
    attn = GPTAttention(128, 2, dropout=0.5)
    seen = []
    attn.out_proj.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()))
    x = torch.tensor(np.random.RandomState(5).randn(2, S, 128)
                     .astype(np.float32))
    attn.eval()
    with torch.no_grad():
        attn(x)
    attn.train()
    with torch.no_grad():
        attn(x)
    ev, tr = seen
    dropped = tr == 0
    torch.testing.assert_close(tr[~dropped], 2 * ev[~dropped], rtol=0,
                               atol=1e-6)
    assert 0.4 < float(dropped.float().mean()) < 0.6


# -- losses -----------------------------------------------------------------
def _jax_loss_and_grads(fn, arrays, labels):
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    loss = fn(*ts, paddle.to_tensor(labels))
    loss.backward()
    return float(loss.numpy()), [t.grad.numpy() for t in ts]


def _torch_loss_and_grads(fn, arrays, labels):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = fn(*ts, torch.tensor(labels))
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("ignore", [False, True])
def test_cross_entropy_matches_jax(ignore):
    rng = np.random.RandomState(6)
    logits = rng.randn(24, 40).astype(np.float32)
    labels = rng.randint(0, 40, 24).astype(np.int64)
    if ignore:
        labels[[0, 5, 6, 17]] = -100
    want, want_g = _jax_loss_and_grads(
        lambda x, y: JF.cross_entropy(x, y), [logits], labels)
    got, got_g = _torch_loss_and_grads(cross_entropy, [logits], labels)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_g[0], want_g[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ignore,chunk", [(False, 128), (True, 5),
                                          (True, 128)])
def test_fused_linear_cross_entropy_matches_jax(ignore, chunk):
    """Chunk 5 shrinks to 4, the largest divisor of S=12."""
    rng = np.random.RandomState(7)
    h = rng.randn(2, 12, 16).astype(np.float32)
    w = (0.3 * rng.randn(16, 50)).astype(np.float32)
    labels = rng.randint(0, 50, (2, 12)).astype(np.int64)
    if ignore:
        labels[0, :3] = -100
        labels[1, 7] = -100
    ii = -100 if ignore else None
    want, want_g = _jax_loss_and_grads(
        lambda a, b, y: JF.fused_linear_cross_entropy(
            a, b, y, chunk_size=chunk, ignore_index=ii), [h, w], labels)
    got, got_g = _torch_loss_and_grads(
        lambda a, b, y: fused_linear_cross_entropy(
            a, b, y, chunk_size=chunk, ignore_index=ii), [h, w], labels)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for g, w_ in zip(got_g, want_g):
        np.testing.assert_allclose(g, w_, rtol=1e-5, atol=1e-6)


def test_fused_loss_equals_unfused_on_the_model():
    m = GPTModel.from_config("tiny", device="cpu", dropout=0.0)
    ids = torch.tensor(np.random.RandomState(8).randint(0, 128, (2, 33)))
    unfused = m(ids[:, :-1], labels=ids[:, 1:])
    m.fused_loss, m.fused_loss_chunk = True, 8
    fused = m(ids[:, :-1], labels=ids[:, 1:])
    torch.testing.assert_close(fused, unfused, rtol=1e-5, atol=1e-6)


# -- optimizers -------------------------------------------------------------
_PARAM_SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "ln.weight": (5,)}


def _decay_fun(name):
    return not (name.endswith("bias") or name.startswith("ln"))


def _opt_pair(kind):
    if kind == "adam_l2":
        return (jopt.Adam(learning_rate=1e-2, weight_decay=0.05),
                lambda ps: Adam(learning_rate=1e-2, weight_decay=0.05,
                                parameters=ps, device="cpu"))
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              apply_decay_param_fun=_decay_fun)
    if kind == "adamw_decay_fun":
        return (jopt.AdamW(**kw),
                lambda ps: AdamW(parameters=ps, device="cpu", **kw))
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
    return (jopt.AdamW(grad_clip=JClip(1.0), **kw),
            lambda ps: AdamW(parameters=ps, device="cpu",
                             grad_clip=ClipGradByGlobalNorm(1.0), **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adam_l2", "adamw_decay_fun",
                                  "adamw_clip"])
def test_optimizer_matches_jax_apply_gradients_tree(kind, dtype):
    import jax.numpy as jnp
    rng = np.random.RandomState(9)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    init = {n: rng.randn(*s).astype(np.float32)
            for n, s in _PARAM_SHAPES.items()}
    grads = [{n: rng.randn(*s).astype(np.float32)
              for n, s in _PARAM_SHAPES.items()} for _ in range(3)]
    j_opt, make = _opt_pair(kind)
    jp = {n: jnp.asarray(a).astype(jdt) for n, a in init.items()}
    js = j_opt.init_state_tree(jp)
    tp = {n: torch.nn.Parameter(torch.tensor(a).to(tdt))
          for n, a in init.items()}
    t_opt = make(list(tp.items()))
    for g in grads:
        jp, js = j_opt.apply_gradients_tree(
            jp, {n: jnp.asarray(a).astype(jdt) for n, a in g.items()}, js,
            jnp.asarray(j_opt.get_lr(), jnp.float32))
        for n, p in tp.items():
            p.grad = torch.tensor(g[n]).to(tdt)
        t_opt.step()
    p_tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-6)
    for n, p in tp.items():
        np.testing.assert_allclose(p.detach().float().numpy(),
                                   np.asarray(jp[n].astype(jnp.float32)),
                                   err_msg=n, **p_tol)
        st = t_opt.state[p]
        assert st["moment1"].dtype == torch.float32
        for key in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_allclose(st[key].numpy(),
                                       np.asarray(js[n][key]), rtol=1e-6,
                                       atol=1e-8, err_msg=f"{n} {key}")


def test_clip_by_global_norm_matches_jax():
    from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
    import jax.numpy as jnp
    rng = np.random.RandomState(10)
    gs = [rng.randn(4, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    want = JClip(1.5).apply_tree({str(i): jnp.asarray(g)
                                  for i, g in enumerate(gs)})
    got = [torch.tensor(g) for g in gs]
    ClipGradByGlobalNorm(1.5)(got)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[str(i)]),
                                   rtol=1e-6, atol=1e-7)


# -- the slice --------------------------------------------------------------
SLICE = dict(num_layers=2, hidden_size=128, num_heads=2, vocab_size=128,
             max_position=128)


def _slice_pair(merge_k):
    paddle.seed(11)
    jm = JaxGPT(**SLICE, dropout=0.0, fused_loss=True)
    tm = GPTModel(**SLICE, dropout=0.0, fused_loss=True)
    load_paddle_tpu_state(tm, {n: np.asarray(p._data)
                               for n, p in jm.named_parameters()})
    kw = dict(learning_rate=1e-3, weight_decay=0.01,
              apply_decay_param_fun=_decay_fun)
    jstrat = tstrat = None
    if merge_k > 1:
        jstrat, tstrat = JaxStrategy(), DistributedStrategy()
        for s in (jstrat, tstrat):
            s.gradient_merge = True
            s.gradient_merge_configs = {"k_steps": merge_k, "avg": True}
    jstep = JaxTrainStep(jm, jopt.AdamW(parameters=jm.parameters(), **kw),
                         loss_fn=None, strategy=jstrat, donate=False)
    tstep = TrainStep(tm, AdamW(parameters=tm.parameters(), device="cpu",
                                **kw),
                      strategy=tstrat, device="cpu")
    return jstep, tstep, tm


@pytest.mark.parametrize("merge_k", [1, 2])
def test_train_steps_match_jax(monkeypatch, merge_k):
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    calls = []
    real = attn_mod.flash_attention
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jstep, tstep, tm = _slice_pair(merge_k)
    ids = np.random.RandomState(12).randint(0, 128, (4, 129)) \
        .astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    for i in range(3):
        want = float(jstep.step([x, y]).numpy())
        got = tstep.step([x, y])
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-4,
                                   err_msg=f"step {i}")
    assert len(calls) == 3 * merge_k * SLICE["num_layers"]
    theirs = {k: np.asarray(v) for k, v in jstep.params.items()}
    ours = export_paddle_tpu_state(tm)
    assert sorted(ours) == sorted(theirs)
    off, total = 0, 0
    for name in ours:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=0,
                                   atol=2e-4, err_msg=name)
        off += int((np.abs(ours[name] - theirs[name]) > 2e-6).sum())
        total += ours[name].size
    assert off <= 1e-3 * total, (off, total)


def test_train_step_with_loss_fn_matches_model_loss():
    """``loss_fn(model(x), y)`` and the model's own unfused loss give the
    same step: same loss, same parameters after it."""
    ids = np.random.RandomState(13).randint(0, 128, (2, 17))
    x, y = ids[:, :-1], ids[:, 1:]
    a = GPTModel.from_config("tiny", device="cpu", seed=1, dropout=0.0)
    b = GPTModel.from_config("tiny", device="cpu", seed=1, dropout=0.0)
    sa = TrainStep(a, AdamW(parameters=a.parameters(), device="cpu"),
                   device="cpu")
    sb = TrainStep(b, AdamW(parameters=b.parameters(), device="cpu"),
                   loss_fn=lambda logits, lab: cross_entropy(
                       logits.reshape(-1, logits.shape[-1]),
                       lab.reshape(-1)), device="cpu")
    for _ in range(2):
        la, lb = sa.step([x, y]), sb.step([x], [y])
        torch.testing.assert_close(la, lb, rtol=1e-6, atol=1e-6)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-6, atol=1e-6, msg=n)


def test_first_loss_is_near_uniform_plus_init_lift():
    """With N(0, 0.02^2) head weights over unit-variance ln_f outputs,
    each logit has variance E * 0.02^2, so the first loss is about
    ln V + E * 0.02^2 / 2 (the check chip_smoke.py makes at gpt3-1.3b's
    width)."""
    cfg = dict(num_layers=2, hidden_size=512, num_heads=8,
               vocab_size=4096, max_position=64)
    m = GPTModel(**cfg, dropout=0.1, fused_loss=True)
    m.reset_parameters(0)
    ids = torch.tensor(np.random.RandomState(0).randint(0, 4096, (4, 65)))
    with torch.no_grad():
        loss = float(m(ids[:, :-1], labels=ids[:, 1:]))
    want = math.log(4096) + 512 * 0.02 ** 2 / 2
    assert abs(loss - want) < 0.1, (loss, want)


# -- what the slice leaves out ---------------------------------------------
@pytest.mark.parametrize("knob", ["use_mp", "use_sp", "moe_experts",
                                  "moe_every"])
def test_unported_model_knobs_raise(knob):
    """Each knob builds its form (the tensor-parallel form for serving on
    a mesh; sequence-parallel attention; MoE blocks, every ``moe_every``-th
    one, ``moe_every`` inert alone), trains over a mesh, and what stays
    serves through the XLA paths over a mesh (where the name's refusal
    was): its greedy streams equal the unsharded XLA engine's."""
    from paddle_tpu_torch.distributed import ServingMesh, build_mesh
    from paddle_tpu_torch.serving import Engine
    kw = {"use_mp": dict(use_mp=True), "use_sp": dict(use_sp=True),
          "moe_experts": dict(moe_experts=2),
          "moe_every": dict(moe_experts=4, moe_every=1)}[knob]
    if knob == "moe_every":
        assert not any(isinstance(b.mlp, MoELayer)
                       for b in GPTModel(**SLICE, moe_every=1).blocks)
    m = GPTModel(**SLICE, dropout=0.0, **kw)
    moe_blocks = [isinstance(b.mlp, MoELayer) for b in m.blocks]
    assert moe_blocks == {"moe_experts": [False, True],
                          "moe_every": [True, True]}.get(
                              knob, [False, False])
    assert m.blocks[0].attn.use_sp == (knob == "use_sp")
    opt = AdamW(parameters=m.parameters(), device="cpu")
    shape = {"use_mp": dict(mp=2), "use_sp": dict(sp=2)}.get(knob,
                                                            dict(ep=2))
    st = TrainStep(m, opt, mesh=build_mesh(devices=["cpu"] * 2, **shape))
    ids = torch.zeros(2, 128, dtype=torch.long)
    assert math.isfinite(float(st.step([ids, ids])))
    mesh = ServingMesh(2 if knob == "use_mp" else 1,
                       1 if knob == "use_mp" else 2, devices=["cpu"] * 2)
    prompts = [np.arange(1, 6 + k) for k in range(2)]
    outs = []
    for kw in (dict(mesh=mesh), dict(device="cpu")):
        eng = Engine(m, attn_impl="xla", num_slots=2, max_seq_len=64, **kw)
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_idle()
        outs.append([r.result(timeout=5).tolist() for r in reqs])
    assert outs[0] == outs[1]


def test_unported_train_knobs_raise():
    """What stays refused on the training side, and what no longer is:
    the multi-process helpers run in one process (``spawn`` calls its
    function, ``host_local_to_global`` is a no-op,
    ``global_from_replicated`` cuts the ranks' rows); ``metrics=`` runs (its
    outputs in ``last_metric_outs``); the mesh knobs of the
    port's own ``DistributedStrategy`` run, and so does a pipeline beside
    data parallelism, whose loss equals the one-device model's.  A
    learning rate that is neither a float nor a scheduler is a
    TypeError."""
    from paddle_tpu_torch.distributed import build_mesh, mesh, spawn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    m = GPTModel(**SLICE, dropout=0.0)
    ids = torch.zeros(4, 8, dtype=torch.long)
    opt = AdamW(parameters=m.parameters(), device="cpu")
    from paddle_tpu_torch.metric import Accuracy
    st = TrainStep(m, opt, loss_fn=GPTPretrainingCriterion(),
                   metrics=[Accuracy()], device="cpu")
    st.step([ids], [ids])
    (correct,), = st.last_metric_outs
    assert tuple(correct.shape) == (4, 8, 1)
    called = []
    spawn(called.append, args=(1,))
    x = np.zeros((2, 3), np.float32)
    assert called == [1] and mesh.host_local_to_global(x) is x
    g = mesh.global_from_replicated(x, build_mesh(dp=2, devices=["cpu"] * 2))
    assert [tuple(t.shape) for t in g.pieces.values()] == [(1, 3), (1, 3)]
    for knob in ("sharding", "pipeline"):
        s = DistributedStrategy()
        setattr(s, knob, True)
        st = TrainStep(m, opt, strategy=s,
                       mesh=build_mesh(dp=2, sharding=2,
                                       devices=["cpu"] * 4))
        assert math.isfinite(float(st.step([ids, ids])))
    for knob in ("mp_degree", "pp_degree", "sharding_degree"):
        s = DistributedStrategy()
        s.hybrid_configs[knob] = 2
        st = TrainStep(m, opt, strategy=s, device="cpu")
        assert math.isfinite(float(st.step([ids, ids])))
    pipe = PipelineLayer(pre=m.embeddings, blocks=list(m.blocks),
                         post=m.head)
    with torch.no_grad():
        want = float(GPTPretrainingCriterion()(pipe(ids), ids))
    st = TrainStep(pipe, opt, loss_fn=GPTPretrainingCriterion(),
                   mesh=build_mesh(dp=2, pp=2, devices=["cpu"] * 4))
    assert float(st.step([ids], [ids])) == pytest.approx(want, rel=1e-5)
    with pytest.raises(TypeError, match="LRScheduler"):
        AdamW(parameters=m.parameters(), learning_rate=object(),
              device="cpu")
    with pytest.raises(ValueError, match="names"):
        bare = AdamW(parameters=m.parameters(), device="cpu",
                     apply_decay_param_fun=_decay_fun)
        m(ids, labels=ids).backward()
        bare.step()


def test_train_step_runs_on_the_card_unless_told_otherwise():
    """``from_config``, the optimizers and ``TrainStep`` default to the
    card; without one each raises instead of quietly training on the
    CPU, even over a model the plain constructor built on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        GPTModel.from_config("tiny")
    m = GPTModel(**SLICE)
    for make in (lambda: AdamW(parameters=m.parameters()),
                 lambda: Adam(parameters=m.parameters()),
                 lambda: TrainStep(m, AdamW(parameters=m.parameters(),
                                            device="cpu"))):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            make()


def test_train_step_and_optimizer_never_move_weights():
    """Parameters that lie elsewhere than the asked device raise; the
    model stays where it was."""
    m = GPTModel(**SLICE)
    with pytest.raises(ValueError, match="never moves weights"):
        TrainStep(m, AdamW(parameters=m.parameters(), device="cpu"),
                  device="meta")
    with pytest.raises(ValueError, match="never moves weights"):
        AdamW(parameters=m.named_parameters(), device="meta")
    assert all(p.device.type == "cpu" for p in m.parameters())
