"""fleet.utils — recompute (activation checkpointing), counterpart of
``paddle_tpu/distributed/fleet/utils.py``.

Reference parity: ``paddle.distributed.fleet.utils.recompute`` (dygraph) and
the static RecomputeOptimizer (``fluid/backward.py:725`` — re-forward of
checkpoint segments in the grad program).

The JAX package remats a traced segment with ``jax.checkpoint``; the port
runs ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which
keeps only the segment's inputs and runs the segment's forward again in
backward.  ``policy`` says what the segment keeps besides:

* ``"full"`` / ``"nothing"`` / None: nothing (plain checkpoint);
* ``"dots"``: the outputs of the matmul aten ops (``mm``, ``addmm``,
  ``bmm``), everything else recomputed — as
  ``dots_with_no_batch_dims_saveable`` keeps the MXU outputs;
* ``"everything"``: every op's output but those of ops that write
  their operands (dropout's ``bernoulli_``), which run again.

The two selective policies run through
``create_selective_checkpoint_contexts``.  Under every policy the
allocation ops (``empty``, ``empty_like``, ...) are recomputed, so a
hand-written kernel launched inside the segment (the flash forward, which
sees no aten op of its own) runs again in backward into a fresh buffer,
never into the one its first forward wrote.  A recomputed forward draws
the same dropout masks (checkpoint restores the default CPU and CUDA
generators, which is all the port's dropouts draw from) and casts as the
first did: the segment runs under the ``amp.auto_cast`` state taken when
it was first called, since backward runs outside the caller's
``auto_cast``.

On a rank of a mesh run (``collective.run_ranks``) the segment's first
run records the results of the collectives inside it, and the
recomputation — one rank at a time, in backward, with no other rank to
meet — takes them back in order (``collective.in_region``); the
collectives' backward is the first run's graph.  A recomputed segment
that reads a rank's random stream draws what the first run drew: the
checkpoint restores the generators, which hold the rank's stream while
it runs.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ... import amp
from .. import collective

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default)
_FRESH = (_aten.empty.memory_format, _aten.empty_like.default,
          _aten.empty_strided.default, _aten.new_empty.default,
          _aten.new_empty_strided.default)


def _dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _everything(ctx, op, *args, **kwargs):
    # an op that writes its operands (dropout's bernoulli_) runs again on
    # the recomputed buffers: a cached output must never be written
    return (CheckpointPolicy.PREFER_RECOMPUTE
            if op in _FRESH or op._schema.is_mutable
            else CheckpointPolicy.MUST_SAVE)


REMAT_POLICIES = {
    "full": None,
    "dots": _dots,
    "nothing": None,
    "everything": _everything,
}


def recompute(function, *args, policy=None, **kwargs):
    """Run ``function(*args, **kwargs)`` so its activations are
    recomputed in backward.  ``policy``: a ``REMAT_POLICIES`` key, None,
    or a selective-checkpoint policy function ``(ctx, op, *args,
    **kwargs) -> CheckpointPolicy``.  Under ``no_grad`` the function
    just runs."""
    if isinstance(policy, str):
        if policy not in REMAT_POLICIES:
            raise ValueError(f"recompute: unknown policy {policy!r}; "
                             f"expected one of {sorted(REMAT_POLICIES)}")
        policy = REMAT_POLICIES[policy]
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    state = amp.current_state()
    rank = collective.current_rank()
    region = collective.Region() if rank is not None else None

    def run(*a, **kw):
        with amp.restored(state), (
                collective.in_region(rank, region) if rank is not None
                else contextlib.nullcontext()):
            return function(*a, **kw)

    if policy is None:
        return checkpoint(run, *args, use_reentrant=False, **kwargs)
    return checkpoint(
        run, *args, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     policy), **kwargs)
