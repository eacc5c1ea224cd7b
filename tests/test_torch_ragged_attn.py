"""Ragged paged attention in the PyTorch port, held to the JAX kernel.

``paddle_tpu_torch.ops.ragged_paged_attention_ref`` (the plain PyTorch
version of the CUDA kernel) is compared with the JAX package's
``ragged_paged_attention`` in interpret mode: the streaming body it
ports and the gather body, which is bitwise the ``_slot_attn`` oracle
math.  Tolerance rtol 2e-5 / atol 2e-6, as in tests/test_ragged_attn.py:
the online softmax sums block by block, in another order than one
softmax over the row.  Lanes at or past ``width`` must be exactly 0.

The int8 leg (kernel B2's plain version: ``ragged_paged_attention_ref``
with ``k_scale``/``v_scale``) and the gather body
(``ragged_gather_attention_ref``, B3's plain version, fp and int8) are
held to the JAX kernel at the same tolerance, on int8 pools made by
``quantize_blocks`` from the fp pools; the dequantization is exact in
f32 in both packages, so only the summation order differs.

Tests marked ``cuda`` hold the CUDA kernels to their plain versions on
the card and skip without one.
"""
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import ragged_paged_attn as rpa_mod
from paddle_tpu_torch.ops.ragged_paged_attn import (
    KERNEL_OPS, ragged_gather_attention, ragged_gather_attention_ref,
    ragged_paged_attention, ragged_paged_attention_int8,
    ragged_paged_attention_ref)
from paddle_tpu_torch.serving.quant import quantize_blocks

torch.set_num_threads(1)

# (B, W, H, hd, bs, nb, NB, pos, width): the case of
# tests/test_ragged_attn.py, gpt2-medium head geometry with a parked
# slot and a lane whose horizon is the table's last block, and a
# decode-only batch
CASES = {
    "mixed_hd8": (4, 5, 4, 8, 8, 6, 20, [3, 10, 0, 30], [1, 5, 0, 3]),
    "hd64_bs16": (4, 7, 2, 64, 16, 4, 12, [0, 20, 61, 5], [7, 1, 3, 0]),
    "decode_w1": (3, 1, 2, 16, 8, 5, 16, [0, 17, 39], [1, 1, 1]),
}


def _inputs(case, seed=0):
    B, W, H, hd, bs, nb, NB, pos, width = CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, W, H, hd).astype(np.float32)
    k = rng.randn(NB * bs, H, hd).astype(np.float32)
    v = rng.randn(NB * bs, H, hd).astype(np.float32)
    tables = rng.randint(0, NB, (B, nb)).astype(np.int32)
    return (q, k, v, tables, np.asarray(pos, np.int32),
            np.asarray(width, np.int32), bs)


def _torch(arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("variant", ["stream", "gather"])
def test_ref_matches_jax_kernel(case, variant):
    """The port's plain version against the JAX kernel in interpret
    mode: the streaming body it ports, and the gather body (the
    ``_slot_attn`` oracle math)."""
    import jax.numpy as jnp
    from paddle_tpu.ops.ragged_paged_attn import (
        ragged_paged_attention as jax_rpa)

    q, k, v, tables, pos, width, bs = _inputs(case)
    want = np.asarray(jax_rpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(width),
        block_size=bs, interpret=True, variant=variant))
    got = ragged_paged_attention_ref(*_torch((q, k, v, tables, pos,
                                              width)),
                                     block_size=bs).numpy()
    for b, w in enumerate(width):
        np.testing.assert_allclose(got[b, :w], want[b, :w], rtol=2e-5,
                                   atol=2e-6)
        assert np.all(got[b, w:] == 0.0), "lanes past width must be 0"


def _int8_inputs(case, seed=0):
    """The case's fp pools quantized block by block: int8 code rows and
    f32 scales [NB, H]."""
    q, k, v, tables, pos, width, bs = _inputs(case, seed)
    H, hd = k.shape[1], k.shape[2]
    out = []
    for pool in (k, v):
        c, sc = quantize_blocks(torch.tensor(pool).view(-1, bs, H, hd))
        out += [c.reshape(-1, H, hd).numpy(), sc.numpy()]
    kc, ks, vc, vs = out
    return q, kc, vc, tables, pos, width, ks, vs, bs


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("variant", ["stream", "gather"])
def test_int8_ref_matches_jax_kernel(case, variant):
    """int8 pools with per-block per-head scales: the port's plain
    versions (stream: B2's; gather: B3's) against the JAX kernel in
    interpret mode with ``k_scale``/``v_scale``."""
    import jax.numpy as jnp
    from paddle_tpu.ops.ragged_paged_attn import (
        ragged_paged_attention as jax_rpa)

    q, kc, vc, tables, pos, width, ks, vs, bs = _int8_inputs(case)
    want = np.asarray(jax_rpa(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(width),
        block_size=bs, interpret=True, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), variant=variant))
    ref = (ragged_paged_attention_ref if variant == "stream"
           else ragged_gather_attention_ref)
    t = _torch((q, kc, vc, tables, pos, width, ks, vs))
    got = ref(*t[:6], block_size=bs, k_scale=t[6], v_scale=t[7]).numpy()
    for b, w in enumerate(width):
        np.testing.assert_allclose(got[b, :w], want[b, :w], rtol=2e-5,
                                   atol=2e-6)
        assert np.all(got[b, w:] == 0.0), "lanes past width must be 0"


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_ref_matches_jax_gather_kernel(case):
    """B3's plain version over fp pools against the JAX gather body."""
    import jax.numpy as jnp
    from paddle_tpu.ops.ragged_paged_attn import (
        ragged_paged_attention as jax_rpa)

    q, k, v, tables, pos, width, bs = _inputs(case)
    want = np.asarray(jax_rpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(width),
        block_size=bs, interpret=True, variant="gather"))
    got = ragged_gather_attention_ref(
        *_torch((q, k, v, tables, pos, width)), block_size=bs).numpy()
    for b, w in enumerate(width):
        np.testing.assert_allclose(got[b, :w], want[b, :w], rtol=2e-5,
                                   atol=2e-6)
        assert np.all(got[b, w:] == 0.0)


@pytest.mark.parametrize("variant", ["stream", "gather"])
@pytest.mark.parametrize("quant", [False, True])
def test_dispatch_on_cpu_takes_each_plain_version(variant, quant):
    """``ragged_paged_attention(variant=, k_scale=, v_scale=)`` sends a
    CPU call to the matching plain version, bit-identically, and counts
    no kernel launch."""
    if quant:
        q, k, v, tables, pos, width, ks, vs, bs = _int8_inputs("mixed_hd8")
        t = _torch((q, k, v, tables, pos, width, ks, vs))
        args, sc = t[:6], dict(k_scale=t[6], v_scale=t[7])
    else:
        *arrays, bs = _inputs("mixed_hd8")
        args, sc = _torch(arrays), {}
    before = {n: op.launches for n, op in KERNEL_OPS.items()}
    got = ragged_paged_attention(*args, block_size=bs, variant=variant,
                                 **sc)
    ref = (ragged_paged_attention_ref if variant == "stream"
           else ragged_gather_attention_ref)
    assert torch.equal(got, ref(*args, block_size=bs, **sc))
    assert {n: op.launches for n, op in KERNEL_OPS.items()} == before


@pytest.mark.parametrize("bad", ["one_scale", "variant", "int8_no_scale",
                                 "fp_with_scale", "scale_shape",
                                 "scale_dtype"])
def test_quantized_wrappers_reject_what_the_kernels_do_not_take(bad):
    q, kc, vc, tables, pos, width, ks, vs, bs = _int8_inputs("mixed_hd8")
    q, kc, vc, tables, pos, width, ks, vs = _torch(
        (q, kc, vc, tables, pos, width, ks, vs))
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs)
    if bad == "one_scale":
        kw["v_scale"] = None
    elif bad == "variant":
        kw["variant"] = "flash"
    elif bad == "int8_no_scale":
        kw.update(k_scale=None, v_scale=None)
    elif bad == "fp_with_scale":
        kc, vc = kc.float(), vc.float()
    elif bad == "scale_shape":
        kw["k_scale"] = ks[:-1].contiguous()
    elif bad == "scale_dtype":
        kw["v_scale"] = vs.double()
    for variant in ("stream", "gather"):
        kw.setdefault("variant", variant)
        with pytest.raises((TypeError, ValueError)):
            ragged_paged_attention(q, kc, vc, tables, pos, width, **kw)
        if bad != "variant":
            kw.pop("variant")


class _StubLib:
    """The kernel library's shared-memory entries, counting calls (no
    card)."""

    def __init__(self, per_config_bytes):
        self.calls = []
        self._bytes = per_config_bytes

    def ragged_paged_attn_smem_bytes(self, *dims):
        self.calls.append(("smem", dims))
        return self._bytes(*dims)

    def ragged_paged_attn_prepare(self, dtype, quant, smem):
        self.calls.append(("prepare", dtype, quant, smem))
        return 0


def test_prepare_runs_once_per_config(monkeypatch):
    """The shared-memory size is asked once per config and the kernels'
    limit raised once per (dtype, quant, card), again only when a config
    needs more — not before every launch."""
    monkeypatch.setattr(rpa_mod, "_smem_sizes", {})
    monkeypatch.setattr(rpa_mod, "_prepared", {})
    lib = _StubLib(lambda W, hd, bs: 100 * W + hd)
    prep = rpa_mod._prepare
    for _ in range(3):
        prep(lib, 0, 0, (64, 64, 16), 0)
    assert lib.calls == [("smem", (64, 64, 16)), ("prepare", 0, 0, 6464)]
    prep(lib, 0, 1, (64, 64, 16), 0)   # int8 leg
    prep(lib, 1, 0, (64, 64, 16), 0)   # bf16
    prep(lib, 0, 0, (8, 64, 16), 0)    # smaller
    prep(lib, 0, 0, (128, 64, 16), 0)  # larger
    prep(lib, 0, 0, (64, 64, 16), 1)   # other card
    assert [c for c in lib.calls if c[0] == "prepare"] == [
        ("prepare", 0, 0, 6464), ("prepare", 0, 1, 6464),
        ("prepare", 1, 0, 6464), ("prepare", 0, 0, 12864),
        ("prepare", 0, 0, 6464)]
    assert sum(c[0] == "smem" for c in lib.calls) == 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_takes_plain_version_on_cpu(case):
    """A CPU tensor goes to the plain version (bit-identical) and does
    not count as a kernel launch."""
    args = _torch(_inputs(case)[:-1])
    bs = _inputs(case)[-1]
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, block_size=bs)
    want = ragged_paged_attention_ref(*args, block_size=bs)
    assert torch.equal(got, want)
    assert ragged_paged_attention.launches == before


def test_horizon_skips_only_masked_blocks():
    """Blocks past a slot's causal horizon are garbage-filled here; the
    output must not change (the walk stops at the horizon, and what it
    skips was fully masked anyway)."""
    q, k, v, tables, pos, width, bs = _inputs("hd64_bs16")
    base = ragged_paged_attention_ref(*_torch((q, k, v, tables, pos,
                                               width)), block_size=bs)
    nb = tables.shape[1]
    live = np.minimum(nb, (pos + np.maximum(width, 1) - 1) // bs + 1)
    k2, v2 = k.copy(), v.copy()
    owned_live = {int(tables[b, j]) for b in range(len(pos))
                  for j in range(live[b])}
    for blk in range(k.shape[0] // bs):
        if blk not in owned_live:
            k2[blk * bs:(blk + 1) * bs] = 1e4
            v2[blk * bs:(blk + 1) * bs] = np.nan
    got = ragged_paged_attention_ref(*_torch((q, k2, v2, tables, pos,
                                              width)), block_size=bs)
    assert torch.equal(got, base)


@pytest.mark.parametrize("bad", ["dtype", "int_dtype", "shape",
                                 "contiguous", "partial_block"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, tables, pos, width = _torch(_inputs("mixed_hd8")[:-1])
    bs = 8
    if bad == "dtype":
        q = q.double()
    elif bad == "int_dtype":
        pos = pos.long()
    elif bad == "shape":
        k = k[:, :2]
    elif bad == "contiguous":
        q = q.transpose(0, 1)
    elif bad == "partial_block":
        bs = 7
    with pytest.raises((TypeError, ValueError)):
        ragged_paged_attention(q, k, v, tables, pos, width, block_size=bs)


def test_build_names_and_stale_lock(tmp_path):
    """The library name carries the source hash; a lock left by a dead
    process is stale, a live one is not (no nvcc needed)."""
    assert "ragged_paged_attn" in _build.sources()
    src, lib, lock, _ = _build._paths("ragged_paged_attn")
    assert src.endswith("csrc/ragged_paged_attn.cu")
    assert os.path.basename(lib).startswith("libragged_paged_attn_")
    assert lib.startswith(_build.BUILD_DIR)
    dead = tmp_path / "dead.lock"
    dead.write_text("999999999")
    assert _build._lock_is_stale(str(dead))
    live = tmp_path / "live.lock"
    live.write_text(str(os.getpid()))
    assert not _build._lock_is_stale(str(live))
    old = tmp_path / "old.lock"
    old.write_text(str(os.getpid()))
    t = time.time() - 2 * _build.STALE_LOCK_S
    os.utime(old, (t, t))
    assert _build._lock_is_stale(str(old))


@pytest.mark.parametrize("bs", [1, 2, 4, 8, 16, 24, 32, 64, 128, 256])
def test_walk_split_depends_only_on_the_table(bs):
    """The stream kernel's split walk, over a grid of table lengths,
    windows, head dims, batches and head counts: pieces of
    G = PIECE_ROWS // bs blocks (at least 1), every table entry in exactly
    one piece, and a workspace of one partial and its merge factor per
    slot, head, piece and lane — the same per (slot, head) whatever the batch and head count, so
    a launch over part of a batch (a mesh rank's) splits every slot as the
    whole batch does."""
    shapes = [(1, 1), (1, 16), (4, 8), (8, 16), (16, 32), (3, 5)]
    for nb in (1, 2, 7, 8, 9, 63, 64, 65, 127, 128, 129, 600):
        g, n = rpa_mod.walk_pieces(nb, bs)
        assert g == max(1, rpa_mod.PIECE_ROWS // bs)
        assert (n - 1) * g < nb <= n * g
        for window in (1, 24, 64, 128):
            for head_dim in rpa_mod.HEAD_DIMS:
                per_slot_head = {
                    rpa_mod.workspace_floats(B, window, H, head_dim, nb,
                                             bs) / (B * H)
                    for B, H in shapes}
                assert per_slot_head == {
                    0 if n == 1 else n * window * (head_dim + 3)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


# (B, W, H, hd, bs, nb, pos, width): walks of many pieces — gpt2-medium's
# head dim and block size with a decode lane and a chunk whose horizon is
# the table's last block, a parked slot deep in its table, a short slot;
# the same at max_seq_len 4096 with a decode lane whose horizon is its
# first piece; an 80-lane chunk (more lane blocks than warps) at the
# tiny model's head dim; and speculative verify windows (decode lanes of
# width k+1 = 4 in a 64-lane window) beside a prefill chunk
LONG_CASES = {
    "hd64_bs16_verify4": (4, 64, 2, 64, 16, 64, [500, 997, 40, 3],
                          [4, 4, 64, 4]),
    "hd64_bs16_nb64": (4, 24, 2, 64, 16, 64, [999, 1000, 300, 0],
                       [1, 24, 0, 17]),
    "hd64_bs16_nb256": (4, 24, 2, 64, 16, 256, [4095, 4072, 300, 30],
                        [1, 24, 0, 1]),
    "hd16_bs8_w80": (3, 80, 2, 16, 8, 40, [200, 239, 0], [80, 1, 5]),
}


def _long_inputs(case, quant, dtype):
    """Card tensors of a LONG_CASES walk: q in ``dtype``, every slot its
    own blocks, fp pools in ``dtype`` or int8 codes with their scales."""
    B, W, H, hd, bs, nb, pos, width = LONG_CASES[case]
    rng = np.random.RandomState(3)
    NB = B * nb + 1
    q = rng.randn(B, W, H, hd).astype(np.float32)
    k = rng.randn(NB * bs, H, hd).astype(np.float32)
    v = rng.randn(NB * bs, H, hd).astype(np.float32)
    tables = (rng.permutation(NB - 1)[:B * nb] + 1).reshape(B, nb)
    dt = getattr(torch, dtype)
    t = _torch((q, k, v, tables.astype(np.int32), np.asarray(pos, np.int32),
                np.asarray(width, np.int32)), "cuda")
    t[0] = t[0].to(dt)
    sc = {}
    if quant:
        (kc, ks), (vc, vs) = (quantize_blocks(p.view(-1, bs, H, hd))
                              for p in t[1:3])
        t[1], t[2] = kc.view(-1, H, hd), vc.view(-1, H, hd)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        t[1], t[2] = t[1].to(dt), t[2].to(dt)
    return t, sc, bs


def _stream(t, sc, bs):
    if sc:
        return ragged_paged_attention_int8(*t, sc["k_scale"], sc["v_scale"],
                                           block_size=bs)
    return ragged_paged_attention(*t, block_size=bs)


def _body(variant, t, sc, bs):
    if variant == "gather":
        return ragged_gather_attention(*t, block_size=bs, **sc)
    return _stream(t, sc, bs)


def _assert_plain(got, t, sc, bs, dtype, ref):
    """``got`` against ``ref`` on the same values in f32: fp32 at rtol
    2e-5 / atol 2e-6 (summation order), bf16 at 2e-2 / 2e-2 (bf16 rounding
    of the output); lanes past width exactly 0."""
    ref_t = [x.float() if x.is_floating_point() else x for x in t]
    want = ref(*ref_t, block_size=bs, **sc)
    tol = (2e-5, 2e-6) if dtype == "float32" else (2e-2, 2e-2)
    w = t[5].tolist()
    for b in range(len(w)):
        torch.testing.assert_close(got[b, :w[b]].float(), want[b, :w[b]],
                                   rtol=tol[0], atol=tol[1])
        assert torch.all(got[b, w[b]:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LONG_CASES))
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_walk_matches_plain_version_on_card(case, quant, dtype):
    """Walks that cross several pieces (merged by the last to finish)
    against the plain version: fp32 at rtol 2e-5 / atol 2e-6, bf16 at
    2e-2 / 2e-2 against the plain version in f32 on the same values;
    lanes past width exactly 0; one launch counted.  The library's piece
    count agrees with ``walk_pieces``."""
    _need_cuda()
    t, sc, bs = _long_inputs(case, quant, dtype)
    nb = t[3].shape[1]
    lib = _build.load("ragged_paged_attn")
    rpa_mod._load()
    assert lib.ragged_paged_attn_pieces(nb, bs) == \
        rpa_mod.walk_pieces(nb, bs)[1] > 1
    op = ragged_paged_attention_int8 if quant else ragged_paged_attention
    before = op.launches
    got = _stream(t, sc, bs)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    _assert_plain(got, t, sc, bs, dtype, ragged_paged_attention_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LONG_CASES))
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_long_walk_matches_plain_version_on_card(case, quant, dtype):
    """B3 over walks of many pieces, every table entry of a slot with a
    real lane, up to max_seq_len 4096 (nb 256, bs 16: no context ceiling
    of its own), against its plain version at the tolerances of
    ``_assert_plain``; one launch counted."""
    _need_cuda()
    t, sc, bs = _long_inputs(case, quant, dtype)
    before = ragged_gather_attention.launches
    got = ragged_gather_attention(*t, block_size=bs, **sc)
    torch.cuda.synchronize()
    assert ragged_gather_attention.launches == before + 1
    _assert_plain(got, t, sc, bs, dtype, ragged_gather_attention_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hd64_bs16_nb64", "hd64_bs16_nb256"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_masked_pieces_add_exactly_zero_on_card(case, quant, dtype):
    """B3 reads and scores every block past each slot's causal horizon,
    whole pieces of them for the decode lanes; overwriting those blocks
    with values of +-1e4 (int8: codes of +-127 under scales of 1e4) leaves
    the output bitwise unchanged: a fully masked piece merges with a factor
    of exactly 0."""
    _need_cuda()
    t, sc, bs = _long_inputs(case, quant, dtype)
    base = ragged_gather_attention(*t, block_size=bs, **sc)
    tables, pos, width = (x.tolist() for x in t[3:])
    past = sorted({blk for b in range(len(pos)) for j, blk in
                   enumerate(tables[b])
                   if j * bs > pos[b] + max(width[b], 1) - 1})
    assert past
    rows = (torch.tensor(past, device="cuda")[:, None] * bs
            + torch.arange(bs, device="cuda")[None]).reshape(-1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    k2, v2 = t[1].clone(), t[2].clone()
    for pool in (k2, v2):
        sign = torch.randint(0, 2, pool[rows].shape, generator=gen,
                             device="cuda") * 2 - 1
        big = 127 if quant else 1e4
        pool[rows] = (sign * big).to(pool.dtype)
    sc2 = {n: x.clone() for n, x in sc.items()}
    for x in sc2.values():
        x[torch.tensor(past, device="cuda")] = 1e4
    got = ragged_gather_attention(t[0], k2, v2, *t[3:], block_size=bs,
                                  **sc2)
    torch.cuda.synchronize()
    assert torch.equal(got, base)


@pytest.mark.cuda
def test_stream_kernel_raises_on_what_it_does_not_take_on_card():
    """A head dim the stream kernel is not compiled for, and a pool that
    does not start on a 16-byte boundary (its cp.async copies), raise
    before any launch."""
    _need_cuda()
    t, _, bs = _long_inputs("hd64_bs16_nb64", False, "float32")
    before = ragged_paged_attention.launches
    q24 = torch.zeros(*t[0].shape[:3], 24, device="cuda")
    k24 = torch.zeros(t[1].shape[0], t[1].shape[1], 24, device="cuda")
    with pytest.raises(ValueError, match="head dim 24"):
        ragged_paged_attention(q24, k24, k24, *t[3:], block_size=bs)
    shifted = torch.zeros(t[1].numel() + 1, device="cuda")[1:] \
        .view(t[1].shape)
    with pytest.raises(ValueError, match="16-byte"):
        ragged_paged_attention(t[0], shifted, t[2], *t[3:], block_size=bs)
    assert ragged_paged_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["stream", "gather"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("part", ["slots", "heads"])
def test_walk_of_part_of_a_batch_is_bitwise_the_whole_on_card(variant, quant,
                                                              part):
    """A launch of either body over some of a batch's slots, or some of
    its heads, gives bitwise the rows the whole batch's launch gives them:
    the split walk depends on each slot's own table, never on the batch
    (the property the serving mesh's launches rely on)."""
    _need_cuda()
    t, sc, bs = _long_inputs("hd64_bs16_nb64", quant, "float32")
    whole = _body(variant, t, sc, bs)
    if part == "slots":
        idx = torch.tensor([1, 3], device="cuda")
        sub = [t[0][idx], t[1], t[2], t[3][idx], t[4][idx], t[5][idx]]
        sub_sc = sc
        want = whole[idx]
    else:
        heads = slice(1, 2)
        sub = [t[0][:, :, heads].contiguous(), t[1][:, heads].contiguous(),
               t[2][:, heads].contiguous(), *t[3:]]
        sub_sc = {n: x[:, heads].contiguous() for n, x in sc.items()}
        want = whole[:, :, heads]
    got = _body(variant, sub, sub_sc, bs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(case, dtype):
    """The CUDA kernel against its plain version on the same inputs:
    fp32 at rtol 2e-5 / atol 2e-6 (summation order); bf16 inputs at
    2e-2 / 2e-2 against the plain version computed in f32 from the same
    bf16 values (bf16 rounding of the output)."""
    _need_cuda()
    q, k, v, tables, pos, width, bs = _inputs(case)
    dt = getattr(torch, dtype)
    args = [t.to(dt) if t.is_floating_point() else t
            for t in _torch((q, k, v, tables, pos, width), "cuda")]
    before = ragged_paged_attention.launches
    got = ragged_paged_attention(*args, block_size=bs)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    assert got.dtype == dt
    ref_args = [t.float() if t.is_floating_point() else t for t in args]
    want = ragged_paged_attention_ref(*ref_args, block_size=bs)
    tol = (2e-5, 2e-6) if dtype == "float32" else (2e-2, 2e-2)
    w = width.tolist()
    for b in range(len(w)):
        torch.testing.assert_close(got[b, :w[b]].float(), want[b, :w[b]],
                                   rtol=tol[0], atol=tol[1])
        assert torch.all(got[b, w[b]:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["int8_stream", "gather_fp",
                                    "gather_int8"])
def test_b2_b3_match_plain_versions_on_card(case, dtype, kernel):
    """Kernels B2 (int8 stream) and B3 (gather, fp and int8 pools)
    against their plain versions on the same inputs: fp32 q at rtol 2e-5
    / atol 2e-6 (summation order; the dequantization is exact in f32),
    bf16 q at 2e-2 / 2e-2 against the plain version in f32 on the same
    bf16 values; each launch is counted on its own wrapper."""
    _need_cuda()
    dt = getattr(torch, dtype)
    if kernel == "gather_fp":
        *arrays, bs = _inputs(case)
        q, k, v, tables, pos, width = _torch(arrays, "cuda")
        k, v = k.to(dt), v.to(dt)
        sc = {}
    else:
        q, k, v, tables, pos, width, ks, vs, bs = _int8_inputs(case)
        q, k, v, tables, pos, width, ks, vs = _torch(
            (q, k, v, tables, pos, width, ks, vs), "cuda")
        sc = dict(k_scale=ks, v_scale=vs)
    q = q.to(dt)
    if kernel == "int8_stream":
        op, ref = ragged_paged_attention_int8, ragged_paged_attention_ref
        before = op.launches
        got = op(q, k, v, tables, pos, width, ks, vs, block_size=bs)
    else:
        op, ref = ragged_gather_attention, ragged_gather_attention_ref
        before = op.launches
        got = op(q, k, v, tables, pos, width, block_size=bs, **sc)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    assert got.dtype == dt
    want = ref(q.float(), k if k.dtype == torch.int8 else k.float(),
               v if v.dtype == torch.int8 else v.float(), tables, pos,
               width, block_size=bs, **sc)
    tol = (2e-5, 2e-6) if dtype == "float32" else (2e-2, 2e-2)
    w = width.tolist()
    for b in range(len(w)):
        torch.testing.assert_close(got[b, :w[b]].float(), want[b, :w[b]],
                                   rtol=tol[0], atol=tol[1])
        assert torch.all(got[b, w[b]:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kernel", ["stream_fp", "stream_int8", "gather_fp",
                                    "gather_int8"])
def test_b4_over_kernels_equals_unsharded_kernel_on_card(case, kernel):
    """Kernel B4 (``sharded_ragged_paged_attention``) on a mesh of ranks
    all on the card — (2, 2), or (2, 1) for an odd slot count — with
    tables of GLOBAL block ids, each slot's blocks in its own dp shard's
    range: one launch of the hand-written kernel for the card's group of
    ranks, and outputs equal to the unsharded kernel on the same logical
    inputs (each (slot, head) runs the same pieces in the same order;
    atol 1e-6)."""
    from paddle_tpu_torch.distributed import ServingMesh, shard, unshard
    from paddle_tpu_torch.ops.ragged_paged_attn import (
        sharded_ragged_paged_attention)
    _need_cuda()
    quant = kernel.endswith("int8")
    if quant:
        q, k, v, _, pos, width, ks, vs, bs = _int8_inputs(case)
    else:
        q, k, v, _, pos, width, bs = _inputs(case)
    B, nb = q.shape[0], CASES[case][5]
    dp = 2 if B % 2 == 0 else 1
    rps = k.shape[0] // bs // dp
    rng = np.random.RandomState(1)
    tables = np.stack([b // (B // dp) * rps + rng.randint(0, rps, nb)
                       for b in range(B)]).astype(np.int32)
    mesh = ServingMesh(2, dp, devices=["cuda:0"] * (2 * dp))
    t = _torch((q, k, v, tables, pos, width), "cuda")
    sc, ssc = {}, {}
    if quant:
        ks_t, vs_t = _torch((ks, vs), "cuda")
        sc = dict(k_scale=ks_t, v_scale=vs_t)
        ssc = dict(k_scale_shards=shard(ks_t, "kv_scale", mesh),
                   v_scale_shards=shard(vs_t, "kv_scale", mesh))
    variant = kernel.split("_")[0]
    want = ragged_paged_attention(*t, block_size=bs, variant=variant, **sc)
    qspec, kvspec = ("dp", None, "mp", None), ("dp", "mp", None)
    op = {"stream_fp": ragged_paged_attention,
          "stream_int8": ragged_paged_attention_int8}.get(
              kernel, ragged_gather_attention)
    before = (sharded_ragged_paged_attention.launches, op.launches)
    outs = sharded_ragged_paged_attention(
        shard(t[0], qspec, mesh), shard(t[1], kvspec, mesh),
        shard(t[2], kvspec, mesh), t[3], t[4], t[5], block_size=bs,
        mesh=mesh, variant=variant, **ssc)
    torch.cuda.synchronize()
    assert (sharded_ragged_paged_attention.launches, op.launches) == \
        (before[0] + 1, before[1] + 1)
    got = unshard(outs, qspec, mesh)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)
