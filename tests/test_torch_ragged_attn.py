"""Ragged paged attention in the PyTorch port, held to the JAX kernel.

``paddle_tpu_torch.ops.ragged_paged_attention_ref`` (the plain PyTorch
version of the CUDA kernel) is compared with the JAX package's
``ragged_paged_attention`` in interpret mode: the streaming body it
ports and the gather body, which is bitwise the ``_slot_attn`` oracle
math.  Tolerance rtol 2e-5 / atol 2e-6, as in tests/test_ragged_attn.py:
the online softmax sums block by block, in another order than one
softmax over the row.  Lanes at or past ``width`` must be exactly 0.

Tests marked ``cuda`` hold the CUDA kernel to its plain version on the
card and skip without one.
"""
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.ragged_paged_attn import (
    ragged_paged_attention, ragged_paged_attention_ref)

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


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


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
