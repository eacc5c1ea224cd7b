"""Losses — counterpart of ``paddle_tpu/nn/functional/loss.py``: every loss
of that file (``cross_entropy`` with ``weight``, ``soft_label``,
``reduction``, ``axis`` and ``label_smoothing``, the BCE, regression,
ranking, margin and CTC losses), ``fused_linear_cross_entropy`` and its
vocab-parallel form.

All are plain PyTorch, as the JAX package leaves them to XLA; each
takes torch tensors or handles (``_io.api``) and passes the JAX
primitive's amp site.  A mean
over kept tokens divides by this call's kept tokens, unless the running
mesh rank's train step names another count
(``collective.RankContext.token_count``; see
``parallel/train_step.py``).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ... import amp
from ...distributed import collective
from ._io import api


def _token_mean(total, kept):
    """``total`` over the kept tokens: ``kept``, or what the running
    rank's ``token_count`` makes of it."""
    kept = kept.to(total.dtype)
    ctx = collective.current_rank()
    if ctx is not None and ctx.token_count is not None:
        kept = ctx.token_count(kept)
    return total / torch.clamp(kept, min=1.0)


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _hard_ce(logp, lab, weight, ignore_index, reduction, label_smoothing):
    """Hard-label CE over the last axis of ``logp`` (log-probabilities)."""
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    if label_smoothing:
        picked = (1 - label_smoothing) * picked \
            + label_smoothing * logp.mean(dim=-1)
    loss = -picked
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        wsel = weight[safe]
        loss = torch.where(valid, loss * wsel, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(
                torch.where(valid, wsel, zero).sum(), min=1e-12)
        return _reduce(loss, reduction)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return _token_mean(loss.sum(), valid.sum())
    return _reduce(loss, reduction)


@api
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over ``axis`` of ``input``.  Hard integer
    labels (with or without a trailing unit axis): positions whose label
    is ``ignore_index`` count neither in the sum nor in the mean, which
    divides by the KEPT tokens (at least 1; by the kept weight with
    ``weight``); soft labels: ``-sum(label * log p)``.  The inputs pass
    the JAX package's ``softmax_with_cross_entropy`` amp site (O2
    computes it in f32; soft labels pass ``..._soft``, on no list)."""
    site = ("softmax_with_cross_entropy_soft" if soft_label
            else "softmax_with_cross_entropy")
    input, label = amp.cast_inputs(site, input, label)
    logits = input.movedim(axis, -1)
    logp = (torch.log_softmax(logits, dim=-1) if use_softmax
            else torch.log(torch.clamp(logits, min=1e-30)))
    if soft_label:
        tgt = label.movedim(axis, -1)
        if label_smoothing:
            tgt = tgt * (1 - label_smoothing) \
                + label_smoothing / logp.shape[-1]
        return _reduce(-(tgt * logp).sum(dim=-1), reduction)
    if label.dim() == logp.dim():
        label = label.movedim(axis, -1)[..., 0]
    return _hard_ce(logp, label, weight, ignore_index, reduction,
                    label_smoothing)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """fluid's form: the per-position loss with the class axis kept (size
    1), and the softmax with ``return_softmax``."""
    from .activation import softmax
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if loss.dim() < logits.dim():
        loss = api(lambda t: t.unsqueeze(axis))(loss)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


@api
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label = amp.cast_inputs("bce_loss", input, label)
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@api
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    logit, label = amp.cast_inputs("sigmoid_cross_entropy_with_logits",
                                   logit, label)
    log_sig, log_sig_neg = F.logsigmoid(logit), F.logsigmoid(-logit)
    pos = label * log_sig if pos_weight is None else \
        pos_weight.detach() * label * log_sig
    loss = -(pos + (1 - label) * log_sig_neg)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@api
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    logit, label = amp.cast_inputs("sigmoid_focal_loss", logit, label)
    p = torch.sigmoid(logit)
    ce = -(label * F.logsigmoid(logit) + (1 - label) * F.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@api
def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp.cast_inputs("mse_loss", input, label)
    return _reduce((input - label).square(), reduction)


@api
def l1_loss(input, label, reduction="mean", name=None):
    input, label = amp.cast_inputs("l1_loss", input, label)
    return _reduce((input - label).abs(), reduction)


@api
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = amp.cast_inputs("smooth_l1_loss", input, label)
    d = (input - label).abs()
    return _reduce(torch.where(d < delta, 0.5 * d * d,
                               delta * (d - 0.5 * delta)), reduction)


@api
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input`` whose class
    axis is 1."""
    input, label = amp.cast_inputs("nll_loss", input, label)
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        wsel = weight[safe]
        loss = torch.where(valid, loss * wsel, zero)
        if reduction == "mean":
            return loss.sum() / torch.clamp(
                torch.where(valid, wsel, zero).sum(), min=1e-12)
        return _reduce(loss, reduction)
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum().to(loss.dtype), min=1.0)
    return _reduce(loss, reduction)


@api
def kl_div(input, label, reduction="mean", name=None):
    input, label = amp.cast_inputs("kldiv_loss", input, label)
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@api
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = amp.cast_inputs("margin_rank_loss", input, other,
                                          label)
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


@api
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    input, label = amp.cast_inputs("hinge_embedding_loss", input, label)
    return _reduce(torch.where(label == 1.0, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


@api
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, label = amp.cast_inputs("cosine_embedding_loss", input1, input2,
                                  label)
    cos = (a * b).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


@api
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = amp.cast_inputs("triplet_margin_loss", input, positive,
                                  negative)

    def dist(u, v):
        return ((u - v).abs() + epsilon).pow(p).sum(-1).pow(1 / p)

    d_pos, d_neg = dist(a, pos), dist(a, neg)
    if swap:
        d_neg = torch.minimum(d_neg, dist(pos, neg))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


@api
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over logits ``[T, B, C]`` (softmax-normalized here, as the JAX
    package's ``optax.ctc_loss`` normalizes them); ``mean`` divides each
    sequence's loss by its label length, then averages."""
    log_probs, = amp.cast_inputs("warpctc", log_probs)
    per_seq = F.ctc_loss(torch.log_softmax(log_probs, dim=-1),
                         labels.long(), input_lengths.long(),
                         label_lengths.long(), blank=blank,
                         reduction="none")
    if reduction == "mean":
        return (per_seq / torch.clamp(label_lengths.to(per_seq.dtype),
                                      min=1.0)).mean()
    if reduction == "sum":
        return per_seq.sum()
    return per_seq


@api
def square_error_cost(input, label):
    input, label = amp.cast_inputs("square_error_cost", input, label)
    return (input - label).square()


@api
def log_loss(input, label, epsilon=1e-4, name=None):
    input, label = amp.cast_inputs("log_loss", input, label)
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


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


@api
def fused_linear_cross_entropy(hidden, weight, labels, chunk_size=128,
                               ignore_index=None, name=None):
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
