"""Flash attention in the PyTorch port, held to the JAX package.

``paddle_tpu_torch.ops.flash_attention`` runs its plain versions on the
CPU (the FlashAttention-2 recurrence in plain PyTorch: forward with the
online softmax, dK/dV and dQ recomputing the probabilities from the
saved log-sum-exp).  Here they are compared, forward and backward,
with the JAX package's ``_reference_attention`` (the oracle of the
upstream Pallas flash kernel) and its ``jax.vjp``, in fp32: output at
atol 1e-5 (the online softmax sums block by block, in another order
than one softmax over the row), gradients at atol 1e-4 (the backward
recomputes p from lse and sums over S in another order).

The dispatch of ``scaled_dot_product_attention`` is checked too: CPU
tensors never load the CUDA library, shapes outside the gate take the
reference attention, and a device without a kernel raises.

Tests marked ``cuda`` hold the three CUDA kernels to their plain
versions on the card and skip without one (jax is imported only inside
the CPU tests: the card has none).  Two of them drive the kernels
through the model: under ``use_recompute`` and O1 the forward kernel
launches twice a layer and each backward kernel once, all on the
tensor-core route; under ``auto_cast(dtype="float16")`` the fp16 q, k, v
take the tensor-core route too and match the plain versions.  On the
CPU, the plain route in fp16 is held to the JAX package's
``scaled_dot_product_attention`` under its fp16 ``auto_cast``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.functional import attention as attn_mod
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# (B, S, H, D, causal, n_segments): causal, causal + packed documents of
# uneven lengths, a head dim of 128, and segments without causal
CASES = {
    "causal_s128": (2, 128, 2, 64, True, 0),
    "causal_seg_s256": (2, 256, 2, 64, True, 3),
    "causal_hd128": (1, 128, 2, 128, True, 0),
    "seg_only_s192": (1, 192, 3, 64, False, 4),
}


def _segments(B, S, n, rng):
    """int32 [B, S] ids of ``n`` packed documents of uneven lengths (0 =
    one document)."""
    if not n:
        return None
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), n - 1, replace=False))
        seg[b] = np.searchsorted(cuts, np.arange(S), side="right")
    return seg


def _inputs(case, seed=0):
    B, S, H, D, causal, nseg = CASES[case]
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do, _segments(B, S, nseg, rng), causal


def _jax_reference(q, k, v, do, seg, causal, dtype="float32"):
    """JAX's ``_reference_attention`` and its ``jax.vjp`` on q, k, v, do
    cast to ``dtype``; the output and dq, dk, dv as f32 numpy."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.nn.functional.attention import _reference_attention
    mask = None
    if seg is not None:
        s = jnp.asarray(seg)
        mask = (s[:, :, None] == s[:, None, :])[:, None]

    def f(a, b, c):
        return _reference_attention(a, b, c, mask, None, causal)

    out, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    grads = vjp(jnp.asarray(do, dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax_reference(case):
    """Forward at atol 1e-5, dq/dk/dv at atol 1e-4 (fp32)."""
    q, k, v, do, seg, causal = _inputs(case)
    want_o, want_g = _jax_reference(q, k, v, do, seg, causal)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tseg = None if seg is None else torch.tensor(seg)
    o = fa.flash_attention(tq, tk, tv, tseg, causal=causal)
    o.backward(torch.tensor(do))
    np.testing.assert_allclose(o.detach().numpy(), want_o, rtol=0,
                               atol=1e-5)
    for name, t, g in zip("qkv", (tq, tk, tv), want_g):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax_reference_bf16(case):
    """The op on bf16 inputs (the training slice's dtype) against JAX's
    reference and its vjp on the same bf16 values: every output at rtol
    2e-2 / atol 2e-2 and a relative L2 error of 1e-2, as the card holds
    its bf16 kernels.  JAX rounds the scores, the probabilities and each
    product's output to bf16; the plain versions compute in f32 and round
    only their outputs, so they differ by about one bf16 ulp at magnitudes
    of 2-4 (measured up to 1.6e-2 absolute, 5.2e-3 relative L2)."""
    q, k, v, do, seg, causal = _inputs(case)
    want_o, want_g = _jax_reference(q, k, v, do, seg, causal, "bfloat16")
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    tseg = None if seg is None else torch.tensor(seg)
    o = fa.flash_attention(tq, tk, tv, tseg, causal=causal)
    o.backward(torch.tensor(do).to(torch.bfloat16))
    got = [o.detach(), tq.grad, tk.grad, tv.grad]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, [want_o, *want_g]):
        assert g.dtype == torch.bfloat16, name
        g = g.float().numpy()
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2, err_msg=name)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 1e-2, f"{name}: relative L2 error {rel:.3e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_ops_agree_with_autograd(case):
    """The three plain versions against autograd through a dense torch
    softmax on the same f32 inputs: lse is the log of the row's
    normaliser, and dk/dv/dq are the dense gradients (atol 1e-4)."""
    q, k, v, do, seg, causal = _inputs(case, seed=1)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tseg = None if seg is None else torch.tensor(seg)
    B, S, H, D = q.shape
    scale = D ** -0.5
    vis = fa._visible(0, S, 0, S, causal, tseg, "cpu")
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * scale
    s = s.masked_fill(~vis, float("-inf"))
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), tv)
    dense.backward(torch.tensor(do))
    o, lse = fa.flash_fwd(tq.detach(), tk.detach(), tv.detach(), tseg,
                          causal=causal, sm_scale=scale)
    torch.testing.assert_close(o, dense.detach(), rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(s.detach(), -1),
                               rtol=0, atol=1e-5)
    tdo = torch.tensor(do)
    di = (o * tdo).sum(-1).transpose(1, 2).contiguous()
    args = (tq.detach(), tk.detach(), tv.detach(), tdo, lse, di, tseg)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, sm_scale=scale)
    dq = fa.flash_bwd_dq(*args, causal=causal, sm_scale=scale)
    for got, t in ((dq, tq), (dk, tk), (dv, tv)):
        torch.testing.assert_close(got, t.grad, rtol=0, atol=1e-4)


def test_fully_masked_tile_adds_exact_zero():
    """A key tile that no query of a query tile can see (other segments)
    contributes exactly 0 to dk/dv, never NaN."""
    B, S, H, D = 1, 128, 1, 64
    rng = np.random.RandomState(3)
    q, k, v, do = (torch.tensor(rng.randn(B, S, H, D).astype(np.float32))
                   for _ in range(4))
    seg = torch.zeros(B, S, dtype=torch.int32)
    seg[:, 64:] = 1                     # two tiles, two documents
    o, lse = fa.flash_fwd(q, k, v, seg, causal=False, sm_scale=D ** -0.5)
    di = (o * do).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, seg, causal=False,
                              sm_scale=D ** -0.5)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    # document 1's queries alone give tile 1's gradient
    o1, lse1 = fa.flash_fwd(q[:, 64:], k[:, 64:], v[:, 64:], None,
                            causal=False, sm_scale=D ** -0.5)
    di1 = (o1 * do[:, 64:]).sum(-1).transpose(1, 2).contiguous()
    dk1, dv1 = fa.flash_bwd_dkv(q[:, 64:], k[:, 64:], v[:, 64:],
                                do[:, 64:], lse1, di1, None, causal=False,
                                sm_scale=D ** -0.5)
    torch.testing.assert_close(dk[:, 64:], dk1, rtol=0, atol=1e-6)
    torch.testing.assert_close(dv[:, 64:], dv1, rtol=0, atol=1e-6)


# -- dispatch -------------------------------------------------------------
def _count_flash(monkeypatch):
    calls = []
    real = attn_mod.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", counting)
    return calls


def test_cpu_never_loads_the_cuda_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU path tried to load csrc/{name}.cu")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    calls = _count_flash(monkeypatch)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
              fa.flash_bwd_dq.launches)
    q, k, v, do, _, _ = _inputs("causal_s128")
    tq = torch.tensor(q, requires_grad=True)
    out = scaled_dot_product_attention(tq, torch.tensor(k), torch.tensor(v),
                                       is_causal=True)
    out.backward(torch.tensor(do))
    assert calls == [tq.shape]
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == before


@pytest.mark.parametrize("shape", [
    "below_min_seq", "seq_not_128", "sq_ne_sk", "mask", "head_dim_32"])
def test_gate_sends_other_shapes_to_reference(monkeypatch, shape):
    """Outside the gate, attention is ``_reference_attention`` — exactly
    its output, and the flash op is never called."""
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 128)
    calls = _count_flash(monkeypatch)
    rng = np.random.RandomState(4)
    sq, sk, d, mask = {"below_min_seq": (64, 64, 64, None),
                       "seq_not_128": (192, 192, 64, None),
                       "sq_ne_sk": (128, 256, 64, None),
                       "mask": (128, 128, 64, "bool"),
                       "head_dim_32": (128, 128, 32, None)}[shape]
    q = torch.tensor(rng.randn(1, sq, 2, d).astype(np.float32))
    k = torch.tensor(rng.randn(1, sk, 2, d).astype(np.float32))
    v = torch.tensor(rng.randn(1, sk, 2, d).astype(np.float32))
    m = None
    if mask:
        m = torch.tensor(rng.rand(1, 1, sq, sk) > 0.3)
        m[..., 0] = True
    got = scaled_dot_product_attention(q, k, v, attn_mask=m, is_causal=True)
    want = attn_mod._reference_attention(q, k, v, m, None, True)
    assert calls == []
    assert torch.equal(got, want)


def test_gate_takes_flash_at_min_seq(monkeypatch):
    """At the gate (S = FLASH_MIN_SEQ, multiples of 128, hd 64) with
    segment ids, the flash op runs and agrees with the dense fallback
    that the JAX package takes off the TPU (atol 1e-5)."""
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 256)
    calls = _count_flash(monkeypatch)
    q, k, v, _, seg, _ = _inputs("causal_seg_s256")
    args = [torch.tensor(a) for a in (q, k, v)]
    tseg = torch.tensor(seg)
    got = scaled_dot_product_attention(*args, is_causal=True,
                                       segment_ids=tseg)
    assert len(calls) == 1
    mask = (tseg[:, :, None] == tseg[:, None, :])[:, None]
    want = attn_mod._reference_attention(*args, mask, None, True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _strided(ids):
    """The same int32 ids as a non-contiguous view (every other column of
    a wider tensor)."""
    wide = torch.zeros(*ids.shape, 2, dtype=torch.int32, device=ids.device)
    wide[..., 0] = ids
    view = wide[..., 0]
    assert not view.is_contiguous()
    return view


def test_segment_ids_of_any_integer_layout_take_the_flash_route(monkeypatch):
    """Segment ids valid for the reference (any ``[B, S]`` integer array)
    serve on the flash route: int64 ids and a strided int32 view give
    exactly the int32 call's output and gradients."""
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 256)
    calls = _count_flash(monkeypatch)
    q, k, v, do, seg, _ = _inputs("causal_seg_s256")
    ids32 = torch.tensor(seg)
    results = []
    for ids in (ids32, ids32.long(), _strided(ids32)):
        tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        out = scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                           segment_ids=ids)
        out.backward(torch.tensor(do))
        results.append([out.detach(), tq.grad, tk.grad, tv.grad])
    assert len(calls) == 3
    for got in results[1:]:
        for g, w in zip(got, results[0]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.float16, 64, "tensor_core"), (torch.float16, 128, "tensor_core"),
    (torch.float32, 64, "scalar"), (torch.float32, 128, "scalar")])
def test_route_by_dtype_and_head_dim(dtype, head_dim, want):
    """bf16 and fp16 take the tensor-core kernels, float32 the scalar ones
    (TF32 would break its tolerances); the forward, dK/dV and dQ all follow
    the route."""
    assert fa.route(dtype, head_dim) == want
    sm90 = want == "tensor_core"
    assert fa.entry("fwd", dtype, head_dim) == (
        want, "flash_fwd_sm90_launch" if sm90 else "flash_fwd_launch")
    assert fa.entry("bwd_dkv", dtype, head_dim) == (
        want,
        "flash_bwd_dkv_sm90_launch" if sm90 else "flash_bwd_dkv_launch")
    assert fa.entry("bwd_dq", dtype, head_dim) == (
        want, "flash_bwd_dq_sm90_launch" if sm90 else "flash_bwd_dq_launch")


@pytest.mark.parametrize("dtype,head_dim,err,match", [
    (torch.float64, 128, TypeError, "float64"),
    (torch.int8, 64, TypeError, "int8"),
    (torch.bfloat16, 32, ValueError, "head dim 32"),
    (torch.float32, 256, ValueError, "head dim 256")])
def test_route_raises_for_what_no_kernel_takes(dtype, head_dim, err, match):
    with pytest.raises(err, match=match):
        fa.route(dtype, head_dim)
    for kernel in fa.KERNEL_OPS:
        with pytest.raises(err, match=match):
            fa.entry(kernel, dtype, head_dim)


def test_wrappers_raise_on_what_they_do_not_take():
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="share shape"):
        fa.flash_fwd(q, torch.zeros(1, 64, 2, 64), q, causal=True,
                     sm_scale=1.0)
    with pytest.raises(ValueError, match="segment_ids"):
        fa.flash_fwd(q, q, q, torch.zeros(1, 128, dtype=torch.int64),
                     causal=True, sm_scale=1.0)
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dq(q, q, q, q, lse[:, :, :64], lse, causal=True,
                        sm_scale=1.0)
    # a device with no kernel raises; it does not run the plain version
    m = torch.zeros(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_fwd(m, m, m, causal=True, sm_scale=1.0)
    with pytest.raises(ValueError, match="attn_mask OR segment_ids"):
        scaled_dot_product_attention(
            q, q, q, attn_mask=torch.ones(1, 1, 128, 128, dtype=torch.bool),
            segment_ids=torch.zeros(1, 128, dtype=torch.int32))


# -- on the card ----------------------------------------------------------
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernels_match_plain_versions_on_card(case, dtype):
    """The three CUDA kernels against their plain versions on the same
    inputs.  fp32: o and lse at atol 1e-5, gradients at atol 1e-4
    (summation order); bf16 and fp16: every output at rtol 2e-2 / atol
    2e-2 against the plain version computed in f32 from the same bf16 /
    fp16 values (rounding of the outputs, and of P and dS)."""
    _need_cuda()
    q, k, v, do, seg, causal = _inputs(case)
    dt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.tensor(a, device="cuda").to(dt)
                       for a in (q, k, v, do))
    tseg = None if seg is None else torch.tensor(seg, device="cuda")
    scale = q.shape[-1] ** -0.5
    before = [op.launches for op in fa.KERNEL_OPS.values()]
    o, lse = fa.flash_fwd(tq, tk, tv, tseg, causal=causal, sm_scale=scale)
    di = (o.float() * tdo.float()).sum(-1).transpose(1, 2).contiguous()
    args = (tq, tk, tv, tdo, lse, di, tseg)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, sm_scale=scale)
    dq = fa.flash_bwd_dq(*args, causal=causal, sm_scale=scale)
    torch.cuda.synchronize()
    assert [op.launches for op in fa.KERNEL_OPS.values()] == \
        [n + 1 for n in before]
    f32 = [t.float() for t in (tq, tk, tv, tdo)]
    want_o, want_lse = fa.flash_fwd_ref(*f32[:3], tseg, causal=causal,
                                        sm_scale=scale)
    ref_args = (*f32, want_lse, di, tseg)
    want_dk, want_dv = fa.flash_bwd_dkv_ref(*ref_args, causal=causal,
                                            sm_scale=scale)
    want_dq = fa.flash_bwd_dq_ref(*ref_args, causal=causal, sm_scale=scale)
    if dtype == "float32":
        tol_o, tol_g = (0, 1e-5), (0, 1e-4)
    else:
        tol_o = tol_g = (2e-2, 2e-2)
    torch.testing.assert_close(o.float(), want_o, rtol=tol_o[0],
                               atol=tol_o[1])
    torch.testing.assert_close(lse, want_lse, rtol=tol_o[0], atol=tol_o[1])
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want, rtol=tol_g[0],
                                   atol=tol_g[1])


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_card():
    _need_cuda()
    q = torch.zeros(1, 128, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="head dim 32"):
        fa.flash_fwd(q, q, q, causal=True, sm_scale=1.0)
    q = torch.zeros(1, 96, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_fwd(q, q, q, causal=True, sm_scale=1.0)
    q = torch.zeros(1, 128, 2, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        fa.flash_fwd(q, q, q, causal=True, sm_scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_segment_ids_serve_on_card(dtype):
    """A strided int32 view of segment ids (and int64 ids) through the
    differentiable op on the card: the same output and gradients as
    contiguous int32 ids, with every kernel launched once a call."""
    _need_cuda()
    q, k, v, do, seg, causal = _inputs("causal_seg_s256")
    dt = getattr(torch, dtype)
    ids32 = torch.tensor(seg, device="cuda")
    results = []
    for ids in (ids32, ids32.long(), _strided(ids32)):
        tq, tk, tv = (torch.tensor(a, device="cuda").to(dt).requires_grad_()
                      for a in (q, k, v))
        before = [op.launches for op in fa.KERNEL_OPS.values()]
        out = fa.flash_attention(tq, tk, tv, ids, causal=causal)
        out.backward(torch.tensor(do, device="cuda").to(dt))
        torch.cuda.synchronize()
        assert [op.launches for op in fa.KERNEL_OPS.values()] == \
            [n + 1 for n in before]
        results.append([out.detach(), tq.grad, tk.grad, tv.grad])
    for got in results[1:]:
        for g, w in zip(got, results[0]):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "dots", "everything"])
def test_recompute_relaunches_the_flash_forward_on_card(monkeypatch,
                                                        policy):
    """O1 over fp32 weights, packed rows, recompute: B5a launches twice a
    layer, B5b and B5c once, all on the tensor-core route."""
    _need_cuda()
    monkeypatch.setattr(attn_mod, "FLASH_MIN_SEQ", 256)
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTModel
    m = GPTModel.from_config("tiny", device="cuda", hidden_size=256,
                             num_heads=2, max_position=256, dropout=0.1,
                             fused_loss=True, use_recompute=True,
                             recompute_policy=policy)
    ids = torch.randint(0, 128, (2, 257), device="cuda")
    dl = torch.tensor([[100, 90, 50], [200, 0, 0]])
    before = {k: op.launches for k, op in fa.KERNEL_OPS.items()}
    routes = dict(fa.ROUTE_LAUNCHES)
    with amp.auto_cast(level="O1"):
        loss = m(ids[:, :-1], labels=ids[:, 1:], doc_lens=dl)
    loss.backward()
    torch.cuda.synchronize()
    got = {k: op.launches - before[k] for k, op in fa.KERNEL_OPS.items()}
    assert got == {"fwd": 4, "bwd_dkv": 2, "bwd_dq": 2}
    assert fa.ROUTE_LAUNCHES["scalar"] == routes["scalar"]
    assert torch.isfinite(loss)


@pytest.mark.cuda
def test_fp16_auto_cast_takes_the_tensor_core_route_on_card():
    """Under ``auto_cast(dtype="float16")`` a causal attention at S=2048
    (the flash gate) runs the three tensor-core kernels in fp16 and
    matches the plain versions on the same fp16 values: o and the
    gradients at rtol 2e-2 / atol 2e-2, as bf16."""
    _need_cuda()
    from paddle_tpu_torch import amp
    rng = np.random.RandomState(3)
    q, k, v, do = (torch.tensor(rng.randn(1, 2048, 2, 64).astype(np.float32),
                                device="cuda") for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = {n: op.launches for n, op in fa.KERNEL_OPS.items()}
    routes = dict(fa.ROUTE_LAUNCHES)
    halves = fa.DTYPE_LAUNCHES[torch.float16]
    with amp.auto_cast(dtype="float16"):
        o = attn_mod.scaled_dot_product_attention(*leaves, is_causal=True)
    assert o.dtype == torch.float16
    o.backward(do.half())
    torch.cuda.synchronize()
    assert {n: op.launches - before[n]
            for n, op in fa.KERNEL_OPS.items()} == \
        {"fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}
    assert fa.ROUTE_LAUNCHES["tensor_core"] == routes["tensor_core"] + 3
    assert fa.ROUTE_LAUNCHES["scalar"] == routes["scalar"]
    assert fa.DTYPE_LAUNCHES[torch.float16] == halves + 3
    ref = [t.half().float().requires_grad_() for t in (q, k, v)]
    want = fa.flash_attention_ref(*ref, causal=True)
    want.backward(do.half().float())
    for got, w in ((o, want), *((a.grad, b.grad)
                                for a, b in zip(leaves, ref))):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), w.detach(), rtol=2e-2,
                                   atol=2e-2)


def test_fp16_plain_route_matches_jax_auto_cast(monkeypatch):
    """The port's ``scaled_dot_product_attention`` under ``auto_cast(dtype=
    "float16")`` at S=2048 (the flash gate; on the CPU the plain versions)
    against the JAX package's under its own fp16 ``auto_cast`` on the same
    f32 inputs: JAX casts q, k, v to fp16 and, off the TPU, runs
    ``_reference_attention`` in fp16 (fp16 scores and value product, an f32
    softmax rounded to fp16).  The output and dq/dk/dv at atol 2e-3 (the
    fp16 rounding of JAX's scores and probabilities, against the plain
    versions' f32 arithmetic on the same fp16 values; outputs ~1), and a
    relative L2 error of 2e-3."""
    import paddle_tpu as paddle
    from paddle_tpu import amp as jamp
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch import amp
    calls = []
    real = fa.KERNEL_OPS["fwd"]

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setitem(fa.KERNEL_OPS, "fwd", counted)
    rng = np.random.RandomState(5)
    q, k, v, do = (rng.randn(1, 2048, 2, 64).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False)
                  for a in (q, k, v))
    with jamp.auto_cast(dtype="float16"):
        jo = JF.scaled_dot_product_attention(jq, jk, jv, is_causal=True)
    assert str(jo.dtype).endswith("float16")
    (jo.astype("float32") * paddle.to_tensor(do)).sum().backward()
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    with amp.auto_cast(dtype="float16"):
        to = attn_mod.scaled_dot_product_attention(tq, tk, tv,
                                                   is_causal=True)
    assert to.dtype == torch.float16 and calls == [torch.float16]
    (to.float() * torch.tensor(do)).sum().backward()
    for name, got, want in (("o", to.detach(), jo), ("dq", tq.grad, jq.grad),
                            ("dk", tk.grad, jk.grad),
                            ("dv", tv.grad, jv.grad)):
        g = got.float().numpy()
        w = np.asarray(want.numpy(), np.float32)
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3, err_msg=name)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 2e-3, f"{name}: relative L2 error {rel:.3e}"
