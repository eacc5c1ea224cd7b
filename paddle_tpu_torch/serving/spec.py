"""Speculative decoding proposers: draft cheap, verify in one pass (a
copy of ``paddle_tpu/serving/spec.py``'s proposers).

A PROPOSER guesses ``k`` draft tokens per decoding slot from what the
engine already has; ONE ragged window dispatch scores all k+1 positions
(``Engine(spec_k=k)``: a decode lane is k+1 wide), and the dispatch's
epilogue accepts the longest prefix where the target's pick equals the
draft, plus the one bonus token the target produced at the first
mismatch.  Greedy acceptance is LOSSLESS: every emitted token is the
target model's own pick given its true prefix, so drafts decide only
how many tokens a dispatch yields (1..k+1).  Wrong drafts cost nothing
beyond the window's compute: the write cursor does not advance over
rejected lanes.

Robustness contract: a proposer that RAISES degrades, it does not kill
the tick — the engine counts ``serving.proposer_failures`` and runs the
window with zero drafts for that slot.

``PromptLookupProposer`` drafts from the history alone;
``DraftModelProposer`` drafts with a smaller GPT through
``GPTModel.generate``.
"""
from __future__ import annotations

import numpy as np


class Proposer:
    """Draft-token source for speculative decoding.

    ``propose(history, k)`` receives one slot's full token history
    (prompt + everything emitted so far, the last entry being the
    token whose K/V the next dispatch will write) and returns up to
    ``k`` int draft tokens predicted to FOLLOW it.  Returning fewer
    than ``k`` (or none) is always safe: the engine pads the window by
    repeating the current token, but pad lanes are pure FILLER for the
    static window shape — they are never counted as proposed lanes,
    can never be accepted, and their garbage K/V is rewritten before
    any query can see it, so a shortfall costs nothing and corrupts no
    metric.

    ``vocab_size`` (optional): when not None, the engine asserts it
    matches the target model's vocabulary at construction — a draft
    from a different tokenizer would never match and only burn the
    window compute.
    """

    vocab_size = None

    def propose(self, history, k):
        raise NotImplementedError


class PromptLookupProposer(Proposer):
    """Prompt-lookup drafting: find the most recent earlier occurrence
    of the history's trailing ``ngram`` tokens and propose the tokens
    that followed it.  Free of any draft model: pure numpy on the
    host."""

    def __init__(self, ngram=3, max_window=1024):
        ngram = int(ngram)
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        max_window = int(max_window)
        if max_window < ngram + 1:
            raise ValueError(
                f"max_window ({max_window}) must exceed ngram "
                f"({ngram}) or no match could ever land")
        self.ngram = ngram
        # bound the host-side scan: propose() runs per slot per
        # decode tick, and hits are overwhelmingly recent — a fixed
        # lookback keeps the drafting cost O(max_window), independent
        # of how long the sequence grows
        self.max_window = max_window

    def propose(self, history, k):
        h = np.asarray(history, np.int64).reshape(-1)[-self.max_window:]
        n = self.ngram
        if len(h) < n + 1:
            return h[:0]
        pat = h[-n:]
        # candidate windows must end strictly before the history's
        # last position (the trailing pattern itself never matches)
        wins = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.nonzero((wins == pat[None, :]).all(axis=1))[0]
        if len(hits) == 0:
            return h[:0]
        j = int(hits[-1])          # most recent occurrence wins
        return h[j + n:j + n + k]


class DraftModelProposer(Proposer):
    """Draft with a smaller GPT sharing the target's vocabulary: greedy
    ``generate`` of ``k`` continuation tokens of the slot's history.

    The draft runs EAGER (``generate(compiled=False)``): the history
    grows every tick, and the eager path takes any length without a
    buffer of its own.  Histories longer than the draft model's position
    table are cut to their tail: a draft from a clipped context is still
    a guess, and verification keeps it honest.

    ``weight_dtype="int8"`` relayouts the draft's transformer blocks
    through weight-only int8 (``serving/quant.py``) first: a draft is the
    safest model to quantize, since a rounding-flipped draft token costs
    at most one accepted lane, never output correctness.

    ``propose`` reads the draft's tokens back to the host, so an engine
    drafting with it synchronizes once a slot a tick."""

    def __init__(self, draft_model, weight_dtype=None):
        if weight_dtype not in (None, "int8"):
            raise ValueError(
                f"DraftModelProposer: unsupported weight_dtype "
                f"{weight_dtype!r} (only 'int8')")
        draft_model.eval()
        if weight_dtype == "int8":
            from .quant import relayout_weights_int8
            relayout_weights_int8(draft_model)
        self.model = draft_model
        self.vocab_size = int(
            draft_model.embeddings.word_embeddings.weight.shape[0])
        self._max_position = int(
            draft_model.embeddings.position_embeddings.weight.shape[0])

    def propose(self, history, k):
        h = np.asarray(history, np.int64).reshape(-1)
        keep = self._max_position - int(k)
        if keep < 1:
            return h[:0]
        if len(h) > keep:
            h = h[-keep:]
        out = self.model.generate(h[None, :], max_new_tokens=int(k))
        return out[0, len(h):].cpu().numpy().astype(np.int32)
