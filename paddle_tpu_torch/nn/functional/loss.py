"""Losses — counterpart of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy``, ``fused_linear_cross_entropy`` and its
vocab-parallel form).

All are plain PyTorch, as the JAX package leaves them to XLA.  A mean
over kept tokens divides by this call's kept tokens, unless the running
mesh rank's train step names another count
(``collective.RankContext.token_count``; see
``parallel/train_step.py``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ... import amp
from ...distributed import collective


def _token_mean(total, kept):
    """``total`` over the kept tokens: ``kept``, or what the running
    rank's ``token_count`` makes of it."""
    kept = kept.to(total.dtype)
    ctx = collective.current_rank()
    if ctx is not None and ctx.token_count is not None:
        kept = ctx.token_count(kept)
    return total / torch.clamp(kept, min=1.0)


def cross_entropy(input, label, ignore_index=-100):
    """Mean softmax cross entropy over the last axis of ``input`` with
    hard integer labels.  Positions whose label is ``ignore_index`` count
    neither in the sum nor in the mean's normalizer (mean over KEPT
    tokens, at least 1).  The inputs pass the JAX package's
    ``softmax_with_cross_entropy`` amp site (O2 computes it in f32)."""
    input, label = amp.cast_inputs("softmax_with_cross_entropy", input,
                                   label)
    logp = torch.log_softmax(input, dim=-1)
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    return _token_mean(loss.sum(), valid.sum())


def _chunk_ce(hc, w, lc, ignore_index):
    """Sum of the per-token CE over one sequence chunk's kept tokens; the
    chunk's logits are f32 ``[B, chunk, V]`` and live only inside."""
    logits = (hc @ w).float()
    logz = torch.logsumexp(logits, dim=-1)
    lab = lc.long()
    if ignore_index is None:
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        return (logz - gold).sum()
    keep = lab != ignore_index
    safe = torch.where(keep, lab, torch.zeros_like(lab))
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(keep, logz - gold, torch.zeros_like(logz)).sum()


def fused_linear_cross_entropy(hidden, weight, labels, chunk_size=128,
                               ignore_index=None):
    """CE(softmax(hidden @ weight), labels) without the whole
    ``[B, S, V]`` logits: the sequence is cut into chunks (the largest
    divisor of S not above ``chunk_size``), each chunk's f32 logits are
    computed, reduced and dropped, and recomputed in backward
    (``torch.utils.checkpoint``).

    hidden ``[B, S, E]``; weight ``[E, V]`` (the JAX package's linear
    layout — pass ``lm_head.weight.t()`` from a torch ``nn.Linear``);
    labels int ``[B, S]``.  ``ignore_index`` excludes those labels from
    the sum and the mean (mean over kept tokens).  Returns the f32 mean
    loss.  The inputs pass the ``fused_linear_cross_entropy`` amp site
    (on no list: the head and CE stay in their dtype), then hidden and
    weight take their common dtype, as jnp's matmul promotes them."""
    hidden, weight, labels = amp.cast_inputs(
        "fused_linear_cross_entropy", hidden, weight, labels)
    hidden, weight = amp.promote(hidden, weight)
    b, s, _ = hidden.shape
    chunk = min(int(chunk_size), s)
    while s % chunk:
        chunk -= 1
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_ce, hidden[:, c0:c0 + chunk], weight,
            labels[:, c0:c0 + chunk], ignore_index, use_reentrant=False)
    if ignore_index is None:
        return total / (b * s)
    return _token_mean(total, (labels != ignore_index).sum())


def _chunk_lse_gold(hc, w, lc, v0):
    """``[2, B, chunk]``: the logsumexp of one chunk's logits over this
    rank's vocab columns ``v0 ..`` and the label's logit where the label
    falls among them (0 elsewhere)."""
    logits = (hc @ w).float()
    lab = lc.long() - v0
    mine = (lab >= 0) & (lab < logits.shape[-1])
    safe = torch.where(mine, lab, torch.zeros_like(lab))
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.stack([torch.logsumexp(logits, dim=-1),
                        torch.where(mine, gold, torch.zeros_like(gold))])


def vocab_parallel_linear_cross_entropy(hidden, weight, labels, axes="mp",
                                        chunk_size=128, ignore_index=None):
    """``fused_linear_cross_entropy`` with ``weight`` this mesh rank's
    columns ``[E, V / n]`` of a vocab split in group order over ``axes``:
    each rank computes its columns' logsumexp and label logits chunk by
    chunk, and the ``n`` partial logsumexps (all-gathered) and label
    logits (all-reduced) make every token's CE, the same on every rank of
    the group.  Off a mesh, or for a group of one, it is
    ``fused_linear_cross_entropy`` over the whole ``weight``."""
    ctx = collective.current_rank()
    group = ctx.group(axes) if ctx is not None else [None]
    if len(group) == 1:
        return fused_linear_cross_entropy(hidden, weight, labels, chunk_size,
                                          ignore_index)
    hidden, weight, labels = amp.cast_inputs(
        "fused_linear_cross_entropy", hidden, weight, labels)
    hidden, weight = amp.promote(hidden, weight)
    b, s, _ = hidden.shape
    chunk = min(int(chunk_size), s)
    while s % chunk:
        chunk -= 1
    v0 = group.index(ctx.rank) * weight.shape[1]
    part = torch.cat([checkpoint(
        _chunk_lse_gold, hidden[:, c0:c0 + chunk], weight,
        labels[:, c0:c0 + chunk], v0, use_reentrant=False)
        for c0 in range(0, s, chunk)], dim=2)
    lse = torch.logsumexp(collective.mesh_all_gather(part[0][None], 0, axes),
                          dim=0)
    tok = lse - collective.mesh_all_reduce(part[1], axes)
    if ignore_index is None:
        return tok.sum() / (b * s)
    keep = labels != ignore_index
    return _token_mean(torch.where(keep, tok, torch.zeros_like(tok)).sum(),
                       keep.sum())
