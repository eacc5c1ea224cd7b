"""Variable-length batching: length buckets + padding — counterpart of
``paddle_tpu/io/bucketing.py``, the same samplers and collates.

The reference absorbs ragged data with LoDTensor + ``sequence_ops``
kernels.  The JAX package quantizes lengths to a small fixed set of
buckets, because XLA compiles one program per shape.  The port runs
eagerly and compiles nothing per shape, but keeps the contract: every
batch is padded up to its bucket's length, so a run meets at most
``len(buckets)`` distinct batch shapes (bounded padding waste, a bounded
set of GEMM shapes and allocator block sizes), and masks / lengths carry
the real extents (the dense + lengths convention of
``nn/functional/sequence.py``).

- ``bucket_for(length, buckets)``        — smallest bucket >= length
- ``pad_to_bucket(arrays, buckets)``     — pad a list of [Li, ...] to one
  [B, Lb, ...] + lengths
- ``BucketedBatchSampler``               — groups same-bucket samples so a
  batch never mixes buckets (minimises padding waste)
- ``bucketed_collate(buckets)``          — DataLoader collate_fn factory
"""
from __future__ import annotations

import math

import numpy as np

from . import BatchSampler, RandomSampler, SequenceSampler


# The JAX package's two ladders, kept so that both packages bucket the
# same data alike: powers of two (the fewest shapes), and the default
# x1.5 geometric ladder, each rung rounded up to a multiple of 8 below
# 1024 and of 128 above (less padding, more shapes).
POW2_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
DEFAULT_BUCKETS = (32, 48, 72, 112, 168, 248, 368, 552, 824, 1280,
                   1920, 2816, 4096)


def bucket_for(length, buckets=DEFAULT_BUCKETS):
    """Smallest bucket >= length (the padded length this sample runs
    at).  Lengths beyond the largest bucket raise — silently growing the
    shape would break the bounded-shapes contract bucketing exists for."""
    for b in buckets:
        if length <= b:
            return int(b)
    raise ValueError(
        f"sequence length {length} exceeds the largest bucket "
        f"{buckets[-1]}; extend `buckets` (each new bucket is one more "
        "batch shape) or truncate upstream")


def pad_to_bucket(arrays, buckets=DEFAULT_BUCKETS, axis=0, pad_value=0,
                  dtype=None):
    """Pad a list of per-sample arrays (ragged along ``axis``) into one
    stacked batch at the COMMON bucket of the longest sample.

    Returns (batch [N, ..., Lb, ...], lengths [N] int64).
    """
    arrays = [np.asarray(a) for a in arrays]
    lengths = np.asarray([a.shape[axis] for a in arrays], np.int64)
    lb = bucket_for(int(lengths.max()), buckets)
    out = []
    for a in arrays:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, lb - a.shape[axis])
        out.append(np.pad(a, pad, constant_values=pad_value))
    batch = np.stack(out)
    if dtype is not None:
        batch = batch.astype(dtype)
    return batch, lengths



class _LengthAwareSampler(BatchSampler):
    """Shared plumbing for length-aware batch samplers: default
    length_fn, per-index memoization (the default materializes samples
    — uncached, every epoch and every len() would re-decode the dataset
    in the MAIN process, serializing ahead of the workers), and
    shuffled/sequential index order."""

    def _init_lengths(self, dataset, length_fn, shuffle):
        self.dataset = dataset
        self.shuffle = shuffle
        if length_fn is None:
            def length_fn(i):
                sample = dataset[i]
                first = sample[0] if isinstance(sample, (tuple, list)) \
                    else sample
                return len(first)
        raw = length_fn
        self._length_memo = {}

        def cached(i):
            if i not in self._length_memo:
                self._length_memo[i] = raw(i)
            return self._length_memo[i]

        self.length_fn = cached
        self.sampler = (RandomSampler(dataset) if shuffle
                        else SequenceSampler(dataset))


class BucketedBatchSampler(_LengthAwareSampler):
    """Batch sampler that never mixes buckets inside a batch.

    ``length_fn(i)`` maps a dataset index to its sequence length (default:
    ``len(dataset[i][0])``).  Batches are formed within each bucket, so a
    training run meets at most ``len(buckets)`` padded lengths instead of
    one per distinct length."""

    def __init__(self, dataset, batch_size=1, buckets=DEFAULT_BUCKETS,
                 length_fn=None, shuffle=False, drop_last=False):
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.drop_last = drop_last
        self._init_lengths(dataset, length_fn, shuffle)
        self._len_cache = None

    def __iter__(self):
        pools = {b: [] for b in self.buckets}
        for idx in self.sampler:
            b = bucket_for(self.length_fn(idx), self.buckets)
            pools[b].append(idx)
            if len(pools[b]) == self.batch_size:
                yield pools[b]
                pools[b] = []
        if not self.drop_last:
            for b in self.buckets:
                if pools[b]:
                    yield pools[b]

    def __len__(self):
        # computed once: the default length_fn materializes samples, and
        # fit/callbacks call len(loader) every epoch
        if self._len_cache is None:
            counts = {b: 0 for b in self.buckets}
            for i in range(len(self.dataset)):
                counts[bucket_for(self.length_fn(i), self.buckets)] += 1
            total = 0
            for c in counts.values():
                total += (c // self.batch_size if self.drop_last
                          else math.ceil(c / self.batch_size))
            self._len_cache = total
        return self._len_cache


def bucketed_collate(buckets=DEFAULT_BUCKETS, pad_value=0,
                     ragged_fields=(0,), axis=0):
    """collate_fn factory: pads the ragged fields of each sample tuple to
    the batch's bucket and appends a lengths array per ragged field.

    Sample = tuple of arrays; fields in ``ragged_fields`` are ragged
    along ``axis``.  Batch = (*padded_or_stacked_fields, *lengths)."""

    def collate(samples):
        n_fields = len(samples[0]) if isinstance(samples[0],
                                                 (tuple, list)) else 1
        if n_fields == 1 and not isinstance(samples[0], (tuple, list)):
            samples = [(s,) for s in samples]
        out, lens = [], []
        for f in range(n_fields):
            col = [np.asarray(s[f]) for s in samples]
            if f in ragged_fields:
                batch, lengths = pad_to_bucket(col, buckets, axis=axis,
                                               pad_value=pad_value)
                out.append(batch)
                lens.append(lengths)
            else:
                out.append(np.stack(col))
        return tuple(out) + tuple(lens)

    return collate


class TokenBudgetBatchSampler(_LengthAwareSampler):
    """Pack sequences into batches by TOKEN budget, not sample count
    (the LLM data path for `core/ragged.py` RaggedTensor: compute is
    proportional to total tokens, so a fixed token capacity gives
    near-zero waste at ANY length skew — strictly better than bucketed
    padding's ~17% at the BASELINE round-3 distribution).

    Packing is pooled first-fit: up to ``num_open`` batches stay open
    and each sample lands in the first one with room, so a long
    document no longer force-closes a half-empty batch (measured on
    the BASELINE round-3 skew: ~2% waste vs 8% for the one-open greedy
    packer and 17% for bucketed padding).  A sample longer than the
    budget raises (truncate upstream, like bucket_for's contract).
    Batches also cap at ``max_batch_size`` rows so row-indexed state
    (labels, row_splits) stays bounded."""

    def __init__(self, dataset, token_budget, length_fn=None,
                 max_batch_size=None, shuffle=False, drop_last=False,
                 num_open=8):
        self.token_budget = int(token_budget)
        self.max_batch_size = max_batch_size
        self.drop_last = drop_last
        self.num_open = max(1, int(num_open))
        self._init_lengths(dataset, length_fn, shuffle)
        self._pending = None

    def _batches(self):
        open_batches = []  # [indices, used_tokens]
        for idx in self.sampler:
            n = self.length_fn(idx)
            if n > self.token_budget:
                raise ValueError(
                    f"TokenBudgetBatchSampler: sample {idx} has {n} "
                    f"tokens > budget {self.token_budget}; truncate "
                    "upstream or raise the budget")
            placed = False
            for entry in open_batches:
                if entry[1] + n <= self.token_budget and not (
                        self.max_batch_size
                        and len(entry[0]) >= self.max_batch_size):
                    entry[0].append(idx)
                    entry[1] += n
                    placed = True
                    break
            if not placed:
                if len(open_batches) >= self.num_open:
                    # emit the fullest bin to make room
                    k = max(range(len(open_batches)),
                            key=lambda i: open_batches[i][1])
                    yield open_batches.pop(k)[0]
                open_batches.append([[idx], n])
        # end-of-epoch flush: pooled packing keeps up to num_open bins
        # open; dropping them ALL under drop_last would lose a biased
        # slice (bins stay open precisely when nearly full), so
        # drop_last only discards bins under half the budget
        for entry in sorted(open_batches, key=lambda e: -e[1]):
            if not self.drop_last or \
                    entry[1] * 2 >= self.token_budget:
                yield entry[0]

    def _materialize(self):
        return list(self._batches())

    def __iter__(self):
        # packing is ORDER-dependent, so len() and the next iteration
        # must see the SAME permutation: whoever runs first materializes
        # the epoch's batches; __iter__ consumes them (and the next
        # epoch reshuffles)
        batches = self._pending or self._materialize()
        self._pending = None
        self._current_len = len(batches)
        return iter(batches)

    def __len__(self):
        """Batch count of the pending epoch if len() runs first, else
        of the RUNNING/last epoch — never a permutation the iterator
        will not see (shuffled counts vary by ±a few batches across
        epochs; progress consumers get the live epoch's number)."""
        if self._pending is not None:
            return len(self._pending)
        if getattr(self, "_current_len", None) is not None:
            return self._current_len
        self._pending = self._materialize()
        return len(self._pending)


def ragged_collate(capacity, value_field=0, extra_fields=(),
                   max_rows=None):
    """collate_fn factory producing (ragged values [capacity, ...],
    row_splits, *extras-stacked) per batch — the RaggedTensor feed for
    a TokenBudgetBatchSampler.  ``capacity`` must cover the sampler's
    token budget (equal is the zero-waste setting).

    ``max_rows`` (recommended: the sampler's max_batch_size) FIXES the
    row dimension too: row_splits pads to [max_rows+1] by repeating the
    total (trailing zero-length rows, which the trash-segment design
    already tolerates) and extras zero-pad to [max_rows] — without it,
    each distinct packed row count is a new shape (one compile each in
    the JAX package's step).  Mask padded rows downstream via
    ``RaggedTensor.lengths() == 0``."""
    import numpy as np

    def collate(samples):
        # PURE numpy: collate runs inside DataLoader workers, which by
        # the io/worker.py fork-safety contract never touch the card
        from ..core.ragged import RaggedTensor
        rows, extras = [], [[] for _ in extra_fields]
        for s in samples:
            tup = s if isinstance(s, (tuple, list)) else (s,)
            rows.append(np.asarray(tup[value_field]))
            for k, f in enumerate(extra_fields):
                extras[k].append(np.asarray(tup[f]))
        flat, splits = RaggedTensor.pack_rows_numpy(rows,
                                                    capacity=capacity)
        outs = [np.stack(e) for e in extras]
        if max_rows is not None:
            b = len(rows)
            if b > max_rows:
                raise ValueError(
                    f"ragged_collate: batch has {b} rows > max_rows "
                    f"{max_rows} (set the sampler's max_batch_size)")
            splits = np.concatenate(
                [splits, np.full(max_rows - b, splits[-1],
                                 splits.dtype)])
            outs = [np.concatenate(
                [e, np.zeros((max_rows - b,) + e.shape[1:], e.dtype)])
                for e in outs]
        return (flat, splits) + tuple(outs)

    return collate
