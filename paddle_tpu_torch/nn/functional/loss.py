"""Losses — counterpart of ``paddle_tpu/nn/functional/loss.py``
(``cross_entropy`` and ``fused_linear_cross_entropy``).

Both are plain PyTorch, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ... import amp


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
    return loss.sum() / torch.clamp(valid.sum().to(loss.dtype), min=1.0)


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
    kept = (labels != ignore_index).sum()
    return total / torch.clamp(kept, min=1).float()
