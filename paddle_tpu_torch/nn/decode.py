"""Sequence decoding — counterpart of ``paddle_tpu/nn/decode.py``:
``BeamSearchDecoder``, ``dynamic_decode`` and ``beam_search_decode``.

The beam state is dense: cell states ``[batch * beam, ...]``, scores,
tokens and finished flags ``[batch, beam]``.  Each step is one batched
cell call, a log-softmax (f32), finished beams extended by the end token
alone at no cost, and one ``topk`` over the flat ``beam * vocab``
candidates; the states follow their parent beams.  The loop stops when
every beam has finished (one host read a step) or after
``max_step_num``; ``gather_tree`` backtraces the parents into whole
sequences ``[batch, beam, T]``, and a sequence's length runs to its
first end token (inclusive).  Exact ties among the candidates may be
ordered differently from ``jax.lax.top_k``.

``dynamic_decode`` returns handles when its initial states were handles
(or anything not a torch tensor), torch tensors otherwise; the cell,
``embedding_fn`` and ``output_fn`` are called with torch tensors.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from .functional._io import has_handle, tree_map, unwrap, wrap
from .functional.extension import gather_tree


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


class BeamSearchDecoder:
    """Beam search over an RNN-style ``cell(inputs, states) -> (out,
    new_states)``; ``embedding_fn`` maps the token ids to the cell's
    inputs, ``output_fn`` the cell's output to the logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[B, ...] -> [B * beam, ...]`` (each row repeated)."""
        out = unwrap(x).repeat_interleave(beam_size, dim=0)
        return wrap(out) if isinstance(x, Tensor) else out

    def initialize(self, initial_cell_states):
        """``(ids, states, log_probs, finished)`` of the first step: the
        states tiled over the beams, only beam 0 live (the others at
        -1e9) so the beams diverge."""
        states = tree_map(
            lambda s: s.repeat_interleave(self.beam_size, dim=0),
            initial_cell_states)
        leaf = _leaves(states)[0]
        batch = leaf.shape[0] // self.beam_size
        dev = leaf.device
        ids = torch.full((batch, self.beam_size), self.start_token,
                         dtype=torch.int64, device=dev)
        log_probs = torch.full((batch, self.beam_size), -1e9,
                               dtype=torch.float32, device=dev)
        log_probs[:, 0] = 0.0
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        return ids, states, log_probs, finished

    def step(self, inputs, states):
        if self.embedding_fn is not None:
            inputs = self.embedding_fn(inputs)
        out, new_states = self.cell(inputs, states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        return logits, new_states


def dynamic_decode(decoder, inits=None, max_step_num=20,
                   output_time_major=False, return_length=False, **kwargs):
    """Drive ``decoder`` until every beam finishes or ``max_step_num``;
    returns ids ``[B, beam, T]`` (``[T, B, beam]`` with
    ``output_time_major``) and, with ``return_length``, the lengths
    ``[B, beam]``."""
    handles = inits is not None and (has_handle(inits) or not isinstance(
        _leaves(inits)[0], torch.Tensor))
    if handles:
        inits = tree_map(lambda s: s._data if isinstance(s, Tensor)
                          else torch.as_tensor(s), inits)
    tokens, states, log_probs, finished = decoder.initialize(inits)
    batch, beam = tokens.shape
    end = decoder.end_token
    step_ids, step_parents = [], []
    for _ in range(max_step_num):
        logits, states = decoder.step(tokens.reshape(-1), states)
        logits = unwrap(logits)
        states = unwrap(states)
        vocab = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(
            batch, beam, vocab)
        fin_row = torch.full((vocab,), -1e9, device=logp.device)
        fin_row[end] = 0.0
        logp = torch.where(finished[:, :, None], fin_row, logp)
        total = (log_probs[:, :, None] + logp).reshape(batch, beam * vocab)
        log_probs, idx = torch.topk(total, beam, dim=-1)
        parents = torch.div(idx, vocab, rounding_mode="floor")
        tokens = idx % vocab
        gather = (torch.arange(batch, device=idx.device)[:, None] * beam
                  + parents).reshape(-1)
        states = tree_map(lambda s: s.index_select(0, gather), states)
        finished = torch.gather(finished, 1, parents) | (tokens == end)
        step_ids.append(tokens)
        step_parents.append(parents)
        if bool(finished.all()):
            break
    seqs_t = gather_tree(torch.stack(step_ids), torch.stack(step_parents))
    seqs_b = seqs_t.permute(1, 2, 0)
    is_end = seqs_b == end
    lengths = torch.where(is_end.any(-1), is_end.int().argmax(-1) + 1,
                          torch.full_like(seqs_b[..., 0], seqs_b.shape[-1]))
    seqs = seqs_t if output_time_major else seqs_b
    out = (seqs, lengths) if return_length else seqs
    return wrap(out) if handles else out


def beam_search_decode(ids, lengths, end_token=None):
    """A beam search's result as a two-level ``RaggedTensor``: the outer
    level groups each source's beam hypotheses, the inner one delimits
    each hypothesis' tokens (``ids [B, beam, T]``, ``lengths [B, beam]``;
    ``end_token`` also cuts each hypothesis after its first end token).
    A length above ``T`` raises."""
    from ..core.ragged import RaggedTensor
    arr = unwrap(ids) if isinstance(ids, (Tensor, torch.Tensor)) \
        else torch.as_tensor(ids)
    lens = unwrap(lengths) if isinstance(lengths, (Tensor, torch.Tensor)) \
        else torch.as_tensor(lengths)
    B, beam, T = arr.shape
    lens = lens.to(device=arr.device, dtype=torch.int32).reshape(B * beam)
    longest = int(lens.max()) if lens.numel() else 0
    if longest > T:
        raise ValueError(
            f"beam_search_decode: a length ({longest}) exceeds the time "
            f"dimension ({T}) — the row_splits would claim tokens the "
            "scatter must drop")
    if end_token is not None:
        is_end = arr.reshape(B * beam, T) == int(end_token)
        first = is_end.int().argmax(-1).to(torch.int32) + 1
        lens = torch.where(is_end.any(-1), torch.minimum(lens, first), lens)
    splits = torch.cat([torch.zeros(1, dtype=torch.int32, device=arr.device),
                        torch.cumsum(lens, 0).to(torch.int32)])
    cap = B * beam * T
    steps = torch.arange(T, device=arr.device)
    slot = torch.where(steps[None, :] < lens[:, None],
                       splits[:-1, None] + steps[None, :],
                       torch.full_like(splits[:-1, None], cap))
    flat = torch.zeros(cap + 1, dtype=arr.dtype, device=arr.device)
    flat[slot.reshape(-1).long()] = arr.reshape(-1)
    outer = (torch.arange(B + 1, device=arr.device) * beam).to(torch.int32)
    return RaggedTensor(Tensor._wrap(flat[:cap]), Tensor._wrap(splits),
                        outer_lods=(Tensor._wrap(outer),))
