"""Mixture-of-Experts — counterpart of ``paddle_tpu/distributed/moe.py``.

Top-k gating with per-expert capacity, the expert FFNs stacked on a
leading E axis, and the load-balancing aux loss (Switch Transformer /
GShard).  The JAX package computes all of it in jnp / XLA (no Pallas
kernel), so the port is plain torch:

* ``top_k_gating`` — the dense form: one-hot ``dispatch`` and
  probability-weighted ``combine`` ``[T, E, C]`` tensors over k rounds of
  argmax routing.
* ``top_k_routing`` — the sort-based form ``MoELayer`` runs: each
  token's k experts, its slot in each expert's queue (round-major, so
  round r of every token claims slots before round r + 1, as in the
  dense form), the keep mask and the gates, in ``O(T k)`` state.
* ``ExpertFFN`` / ``MoELayer`` — the drop-in FFN of a GPT block: tokens
  scattered into an ``[E, C, D]`` expert-major buffer (over-capacity
  slots dropped), each expert's ``gelu(x w1 + b1) w2 + b2`` (the tanh
  GELU, ``jax.nn.gelu``'s default), and the gate-weighted gather back.
* ``collect_moe_aux_loss`` — the sum of every ``MoELayer``'s scaled aux
  loss of the last forward, which ``TrainStep`` adds to the loss.

Capacity is ``max(1, int(capacity_factor * T * k / E))`` from the
input's shape only, so a forward reads nothing back to the host.  Rows
interact through capacity: a token's expert slot depends on every row
before it, padding rows included.

The expert stacks keep the JAX layout (``gate [D, E]``, ``w1 [E, D,
H]``, ``b1 [E, H]``, ``w2 [E, H, D]``, ``b2 [E, D]``), so the weight
bridge copies them as they are.  Their ``partition_spec`` puts them
over the ``ep`` mesh axis, as the JAX package does; the train step
shards them by it, and ``moe_ffn`` on a mesh rank routes over the whole
batch and gathers the experts' outputs over ep (see there).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .. import amp
from .collective import (current_rank, mesh_all_gather, mesh_all_reduce,
                         mesh_exchange, mesh_split)
from .mesh import DATA_AXES


def _aux_loss(probs):
    """``E * sum_e (fraction of tokens whose top-1 is e) * (mean prob of
    e)`` over f32 ``probs [T, E]``."""
    e = probs.shape[-1]
    top1 = probs.argmax(dim=-1)
    frac_tokens = F.one_hot(top1, e).float().mean(dim=0)
    return e * (frac_tokens * probs.mean(dim=0)).sum()


def top_k_gating(logits, k, capacity, dtype=torch.float32):
    """Route each token to its top-k experts subject to per-expert
    capacity, the dense way.  ``logits [T, E]``.  Returns ``(dispatch
    [T, E, C]`` one-hot, ``combine [T, E, C]`` probability-weighted, the
    aux loss scalar).  Over-capacity tokens are dropped."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    aux = _aux_loss(probs)
    dev = logits.device
    dispatch = torch.zeros(t, e, capacity, dtype=dtype, device=dev)
    combine = torch.zeros(t, e, capacity, dtype=dtype, device=dev)
    remaining = probs
    used = torch.zeros(e, dtype=torch.int64, device=dev)
    for _ in range(k):
        choice = remaining.argmax(dim=-1)                      # [T]
        gate = torch.gather(remaining, 1, choice[:, None])[:, 0]
        onehot = F.one_hot(choice, e)                          # [T, E]
        pos_in_e = (torch.cumsum(onehot, dim=0) - 1) * onehot
        pos = (pos_in_e * onehot).sum(dim=-1) + used[choice]
        keep = pos < capacity
        slot = torch.clamp(pos, 0, capacity - 1)
        upd = (onehot.to(dtype)[:, :, None]
               * F.one_hot(slot, capacity).to(dtype)[:, None, :]
               * keep[:, None, None].to(dtype))
        dispatch = dispatch + upd
        combine = combine + upd * gate[:, None, None].to(dtype)
        used = used + (onehot * keep[:, None]).sum(dim=0)
        remaining = remaining * (1.0 - F.one_hot(choice, e).float())
    return dispatch, combine, aux


def top_k_routing(logits, k, capacity):
    """Sort-based top-k routing.  ``logits [T, E]``.  Returns ``(choice
    [T, k]`` expert ids, ``pos [T, k]`` slot within the expert, ``keep
    [T, k]`` bool, ``gates [T, k]`` router probabilities, the aux loss
    scalar).  The stable sort of the round-major flattened choices groups
    them by expert, then round, then token: each expert's queue in the
    dense form's slot-claim order."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    aux = _aux_loss(probs)
    gates, choice = torch.topk(probs, k, dim=-1)               # [T, k]
    flat = choice.t().reshape(-1)                              # [k T]
    sorted_e, order = torch.sort(flat, stable=True)
    idx = torch.arange(t * k, device=logits.device)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    group_start = torch.cummax(torch.where(is_start, idx,
                                           torch.zeros_like(idx)), 0)[0]
    pos_flat = torch.empty_like(idx).scatter_(0, order, idx - group_start)
    pos = pos_flat.reshape(k, t).t()                           # [T, k]
    return choice, pos, pos < capacity, gates, aux


def _global_routing(probs, k, capacity, ctx):
    """Top-k routing of this rank's tokens as one program over the whole
    batch routes them: the capacity queue of each expert runs round-major
    over every data rank's tokens in rank order, so a token's slot counts
    the earlier rounds of every rank and this round of the ranks before
    it.  Returns ``(choice, pos`` (the global slot), ``slot`` (a local
    buffer row, unique per expert), ``gates``) each ``[T, k]``."""
    t, e = probs.shape
    gates, choice = torch.topk(probs, k, dim=-1)               # [T, k]
    onehot = F.one_hot(choice.t(), e)                          # [k, T, E]
    within = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1).t()
    cnt = onehot.sum(dim=1)                                    # [k, E]
    earlier_local = torch.cumsum(cnt, dim=0) - cnt             # rounds < r
    rounds = torch.arange(k, device=probs.device)[None, :]
    slot = within + earlier_local[rounds, choice]
    all_cnt = mesh_exchange(
        cnt, DATA_AXES, lambda parts: [torch.stack(
            [p.to(q.device) for p in parts]) for q in parts],
        "moe.route_counts") if ctx.batch_split else None
    if all_cnt is None:
        return choice, slot, slot, gates
    me = ctx.mesh.index_in(ctx.rank, DATA_AXES)
    tot = all_cnt.sum(0)                                       # [k, E]
    before = all_cnt[:me].sum(0)                               # [k, E]
    offset = (torch.cumsum(tot, dim=0) - tot) + before
    pos = within + offset[rounds, choice]
    return choice, pos, slot, gates


def _global_aux(probs, ctx):
    """The aux loss over the whole batch: top-1 counts and probability
    sums summed over the data ranks (the sums differentiably)."""
    e = probs.shape[-1]
    top1 = F.one_hot(probs.argmax(dim=-1), e).float().sum(0)
    psum = probs.sum(0)
    n = torch.full((), probs.shape[0], dtype=torch.float32,
                   device=probs.device)
    top1 = mesh_all_reduce(top1.detach(), DATA_AXES)
    psum = mesh_all_reduce(psum, DATA_AXES)
    n = mesh_all_reduce(n, DATA_AXES)
    return e * ((top1 / n) * (psum / n)).sum()


def moe_ffn(x, gate_w, w1, b1, w2, b2, k, capacity_factor):
    """The MoE FFN of ``x [B, S, D]``: ``(out [B, S, D], aux)`` (the
    body of the JAX package's ``moe_ffn`` primitive).

    Run as a rank of a mesh (``collective.run_ranks``), the routing and
    the aux loss cover the whole batch when it is split over the data
    axes (the capacity from every rank's tokens, each queue filled in
    global order: ``_global_routing``), and with ``ep > 1`` the rank's
    expert stacks hold its ``E / ep`` experts, whose outputs are gathered
    over ep before the combine."""
    b, s, d = x.shape
    e = gate_w.shape[1]
    t = b * s
    ctx = current_rank()
    split = ctx is not None and ctx.batch_split and len(
        ctx.group(DATA_AXES)) > 1
    t_all = t * len(ctx.group(DATA_AXES)) if split else t
    capacity = max(1, int(capacity_factor * t_all * k / e))
    tokens = x.reshape(t, d)
    logits = tokens @ gate_w.to(x.dtype)
    if ctx is None:
        choice, pos, keep, gates, aux = top_k_routing(logits, k, capacity)
        slot, rows = pos, capacity
    else:
        probs = torch.softmax(logits.float(), dim=-1)
        aux = _global_aux(probs, ctx) if split else _aux_loss(probs)
        choice, pos, slot, gates = _global_routing(probs, k, capacity, ctx)
        keep = pos < capacity
        rows = min(capacity, k * t)
    # scatter tokens into the [E, rows, D] expert-major buffer; a dropped
    # (over-capacity) lane lands on one extra dump row, cut away after
    slot = choice * rows + slot                                # [T, k]
    dump = torch.full_like(slot, e * rows)
    slot_f = torch.where(keep, slot, dump).reshape(-1)
    tok_f = torch.arange(t, device=x.device)[:, None].expand(t, k) \
        .reshape(-1)
    xs = torch.zeros(e * rows + 1, d, dtype=x.dtype,
                     device=x.device).index_add(0, slot_f, tokens[tok_f])
    xs = xs[:-1].reshape(e, rows, d)
    if w1.shape[0] != e:
        # this rank's experts only (ep-sharded stacks)
        xs = mesh_split(xs, 0, "ep")
    h = F.gelu(torch.einsum("ecd,edh->ech", xs, w1.to(x.dtype))
               + b1[:, None, :].to(x.dtype), approximate="tanh")
    ys = (torch.einsum("ech,ehd->ecd", h, w2.to(x.dtype))
          + b2[:, None, :].to(x.dtype))
    if w1.shape[0] != e:
        ys = mesh_all_gather(ys, 0, "ep")
    # combine: gather each (token, round)'s slot, weight by its gate
    got = ys.reshape(e * rows, d)[torch.clamp(slot_f, max=e * rows - 1)]
    wts = gates.to(x.dtype).reshape(-1) * keep.reshape(-1).to(x.dtype)
    out = (got * wts[:, None]).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux.to(x.dtype)


class ExpertFFN(nn.Module):
    """E stacked feed-forward experts: ``w1 [E, D, H]``, ``b1 [E, H]``,
    ``w2 [E, H, D]``, ``b2 [E, D]``; Normal(0, 0.02) weights, zero
    biases."""

    def __init__(self, num_experts, d_model, d_hidden):
        super().__init__()
        self.num_experts = num_experts
        self.w1 = nn.Parameter(torch.empty(num_experts, d_model, d_hidden)
                               .normal_(0.0, 0.02))
        self.b1 = nn.Parameter(torch.zeros(num_experts, d_hidden))
        self.w2 = nn.Parameter(torch.empty(num_experts, d_hidden, d_model)
                               .normal_(0.0, 0.02))
        self.b2 = nn.Parameter(torch.zeros(num_experts, d_model))
        for p, spec in ((self.w1, ("ep", None, None)), (self.b1, ("ep", None)),
                        (self.w2, ("ep", None, None)),
                        (self.b2, ("ep", None))):
            p.partition_spec = spec


class MoELayer(nn.Module):
    """Drop-in MoE FFN (replaces ``GPTMLP`` in a block): ``x [B, S, D]``
    -> router ``gate [D, E]`` -> top-k routing with capacity -> the
    experts -> the gate-weighted combine.  Each forward keeps its aux
    loss (``_last_aux``) for ``aux_loss`` / ``collect_moe_aux_loss``.
    The inputs pass the JAX package's ``moe_ffn`` amp site, which is on
    no list: under O1 the whole FFN stays in its input dtype."""

    def __init__(self, d_model, d_hidden=None, num_experts=4, k=2,
                 capacity_factor=2.0, aux_weight=0.01):
        super().__init__()
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        d_hidden = d_hidden or 4 * d_model
        self.gate = nn.Parameter(torch.empty(d_model, num_experts)
                                 .normal_(0.0, 0.02))
        self.experts = ExpertFFN(num_experts, d_model, d_hidden)
        self._last_aux = None

    def forward(self, x):
        ex = self.experts
        args = amp.cast_inputs("moe_ffn", x, self.gate, ex.w1, ex.b1, ex.w2,
                               ex.b2)
        out, aux = moe_ffn(*args, self.k, self.capacity_factor)
        self._last_aux = aux
        return out

    def aux_loss(self):
        """The last forward's load-balancing loss times ``aux_weight``,
        or None before any forward."""
        if self._last_aux is None:
            return None
        return self._last_aux * self.aux_weight


def collect_moe_aux_loss(layer):
    """Sum of the aux losses of every ``MoELayer`` in ``layer`` (call
    after a forward); None when it holds none."""
    total = None
    for sub in layer.modules():
        if isinstance(sub, MoELayer):
            a = sub.aux_loss()
            if a is not None:
                total = a if total is None else total + a
    return total
