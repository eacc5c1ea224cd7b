"""Ring and Ulysses attention — sequence parallelism over the ``sp`` axis
of a ``DeviceMesh``; counterpart of ``paddle_tpu/distributed/ring.py``.

Layout ``[batch, seq, heads, head_dim]`` (paddle's).  The JAX package
shards the sequence over ``sp`` with ``shard_map`` and rotates K/V with
``lax.ppermute`` inside a ``lax.scan``, whose transpose is the backward.
The port keeps the single-controller shape of its serving mesh: one
process drives every rank.

* ``ring_attention``: the sequence is cut into ``sp`` shards, shard i on
  the i-th device of the ``sp`` axis.  Each rank keeps its Q shard; the
  K/V shards rotate rank to rank (``.to`` the next rank's device) for
  ``sp`` steps, and each step folds one block pair into the rank's
  online softmax (f32 ``o``, ``m``, ``l``).  Under ``causal`` a block
  from a later shard adds nothing, which the JAX package computes and
  selects away and the port skips: the merge of such a block is the
  identity (``alpha = 1``, ``beta = 0``), so the result is the same.
  Autograd through the Python loop takes the place of the scan's
  transpose.  The output shards meet on the query's device.
* ``ulysses_attention``: the all-to-all swaps the sharded axis from
  sequence to heads: rank i attends over the whole sequence for its
  ``H / sp`` heads (``_reference_attention``), and the output swaps back.
  The head count must divide by ``sp``.
* With ``sp == 1`` (no mesh set, or a mesh without an ``sp`` axis) both
  are the degenerate single block, as in the JAX package:
  ``_reference_attention`` in the inputs' dtype, or with dropout the
  f32 ``_single_block_attention`` with dropout on the probabilities.

Dropout: the JAX package folds its key over the ring step and the mesh
coordinates.  The port draws each block's Bernoulli mask from
``rng_key``, a ``torch.Generator`` (the caller's stream), so a
recomputed forward that restores the generator draws the same masks.
As in the JAX package, dropout applies only when a key is given.
"""
from __future__ import annotations

import math

import torch

# the module, not its names: nn.functional.attention imports ops, whose
# ragged wrapper imports this package while attention is still loading
from ..nn.functional import attention as attn_mod
from . import collective
from . import mesh as mesh_mod

_FLOOR = -1e30


def _block_attn(q, k, v, scale, mask_mode, rng_key=None, dropout_p=0.0):
    """One block pair in f32: ``(o`` unnormalized ``[B, H, Sq, D]``, the
    row max ``m`` and sum ``l`` ``[B, H, Sq])``.  ``mask_mode`` 0 = full,
    1 = causal (the diagonal at ``sk - sq``).  Dropout scales the
    probabilities that enter ``o`` only; ``m`` and ``l`` stay undropped,
    so ``o / l`` is ``dropout(softmax(s)) @ v``."""
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if mask_mode == 1:
        sq, sk = s.shape[-2], s.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=s.device).tril(diagonal=sk - sq)
        s = s.masked_fill(~causal, float("-inf"))
    m = torch.clamp(s.amax(dim=-1), min=_FLOOR)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if rng_key is not None and dropout_p > 0.0:
        keep = torch.bernoulli(torch.full_like(p, 1.0 - dropout_p),
                               generator=rng_key)
        p = p * keep / (1.0 - dropout_p)
    return torch.einsum("bhqk,bhkd->bhqd", p, vh), m, l


def _single_block_attention(q, k, v, scale, causal, rng_key, dropout_p):
    """Full attention with dropout on the probabilities, f32 compute,
    ``[B, S, H, D]`` in and out (in q's dtype): the degenerate ring's and
    the Ulysses local attention's path under dropout."""
    o, _, l = _block_attn(q, k, v,
                          scale if scale is not None
                          else 1.0 / math.sqrt(q.shape[-1]),
                          1 if causal else 0, rng_key, dropout_p)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _sp_devices(mesh, axis):
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return None
    return mesh.axis_devices(axis)


def _degenerate(q, k, v, scale, causal, dropout_p, rng_key):
    if dropout_p > 0.0 and rng_key is not None:
        return _single_block_attention(q, k, v, scale, causal, rng_key,
                                       dropout_p)
    return attn_mod._reference_attention(q, k, v, None, scale, causal)


def _shards(x, devices):
    """``x`` cut into ``len(devices)`` equal sequence shards, shard i on
    ``devices[i]``."""
    n = len(devices)
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} is not divisible "
                         f"by the sp degree {n}")
    return [c.to(d) for c, d in zip(x.chunk(n, dim=1), devices)]


def _ring(qs, kv, devices, scale, causal, rng_key, drop, dtype):
    """The ring over ``len(devices)`` ranks: rank i holds query shard
    ``qs[i]`` and K/V shard ``kv[i]`` on ``devices[i]``; returns each
    rank's output shard ``[B, S/n, H, D]`` in ``dtype`` on its device."""
    n = len(devices)
    acc = [None] * n          # per rank: (o, m, l)
    for step in range(n):
        for my in range(n):
            src = (my - step) % n
            if causal and src > my:
                continue      # a later shard's keys: the identity merge
            kb, vb = kv[my]
            o, m, l = _block_attn(qs[my], kb, vb, scale,
                                  1 if causal and src == my else 0,
                                  rng_key, drop)
            if acc[my] is None:
                acc[my] = (o, m, l)
                continue
            ao, am, al = acc[my]
            new_m = torch.maximum(am, m)
            alpha = torch.exp(am - new_m)
            beta = torch.exp(m - new_m)
            acc[my] = (ao * alpha[..., None] + o * beta[..., None], new_m,
                       al * alpha + l * beta)
        if step + 1 < n:
            # K/V rotate one rank on: rank i takes rank i - 1's block
            kv = [(kv[(i - 1) % n][0].to(devices[i]),
                   kv[(i - 1) % n][1].to(devices[i])) for i in range(n)]
    outs = []
    for my in range(n):
        o, _, l = acc[my]
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2).to(dtype))
    return outs


def _on_rank(mesh, axis, q, k, v, combine, name):
    """On a rank of a mesh run (``collective.run_ranks``) and no ``mesh``
    given: with the rank's ``axis`` group larger than one, every rank of
    it hands in its (replicated) q, k, v and ``combine(parts, devices)``
    returns each rank's full output; with a group of one, None for the
    degenerate single block.  ``False`` off a rank."""
    ctx = collective.current_rank()
    if ctx is None or mesh is not None:
        return False
    group = ctx.group(axis)
    if len(group) == 1:
        return None
    if q.shape[1] % len(group):
        raise ValueError(f"sequence length {q.shape[1]} is not divisible "
                         f"by the sp degree {len(group)}")
    devs = ctx.devices(group)
    return collective.mesh_exchange((q, k, v), axis,
                                    lambda parts: combine(parts, devs), name)


def ring_attention(query, key, value, axis="sp", causal=False, scale=None,
                   mesh=None, dropout_p=0.0, rng_key=None):
    """Ring attention of global ``[B, S, H, D]`` q, k, v over the ``axis``
    ranks of ``mesh`` (default the process mesh, ``set_mesh``); the
    result on the query's device and in its dtype.  ``dropout_p`` with a
    ``rng_key`` generator drops attention probabilities, one mask a
    block pair.  Run as a rank of a mesh (``collective.run_ranks``), the
    ranks of the rank's ``axis`` group each hand in their copy and rank
    i takes shard i of it: the ring runs over their devices and every
    rank gets the whole output (the sequence gathered back)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(query.shape[-1])
    drop = dropout_p if rng_key is not None else 0.0

    def over_ranks(parts, devs):
        n = len(devs)
        qs = [p[0].chunk(n, dim=1)[i] for i, p in enumerate(parts)]
        kv = [(p[1].chunk(n, dim=1)[i], p[2].chunk(n, dim=1)[i])
              for i, p in enumerate(parts)]
        outs = _ring(qs, kv, devs, scale, causal, rng_key, drop,
                     query.dtype)
        return [torch.cat([o.to(d) for o in outs], dim=1) for d in devs]

    got = _on_rank(mesh, axis, query, key, value, over_ranks,
                   "ring_attention")
    if got is not False and got is not None:
        return got
    devices = None if got is None else _sp_devices(mesh, axis)
    if devices is None:
        return _degenerate(query, key, value, scale, causal, dropout_p,
                           rng_key)
    outs = _ring(_shards(query, devices),
                 list(zip(_shards(key, devices), _shards(value, devices))),
                 devices, scale, causal, rng_key, drop, query.dtype)
    return torch.cat([o.to(query.device) for o in outs], dim=1)


def ulysses_attention(query, key, value, axis="sp", causal=False,
                      scale=None, mesh=None, dropout_p=0.0, rng_key=None):
    """DeepSpeed-Ulysses sequence parallelism of global ``[B, S, H, D]``
    q, k, v over the ``axis`` ranks of ``mesh``: rank i attends over the
    whole sequence for heads ``i H/sp .. (i + 1) H/sp`` (the all-to-all
    from sequence to head shards), then the output goes back to sequence
    shards and meets on the query's device (on a mesh run's rank: every
    rank of the group gets it, rank j's sequence shard coming from its
    own copy).  Raises ValueError when the head count does not divide by
    the sp degree."""
    heads = query.shape[2]
    use_drop = dropout_p > 0.0 and rng_key is not None

    def check(n):
        if heads % n:
            raise ValueError(
                f"ulysses_attention: local head count {heads} is not "
                f"divisible by the '{axis}' degree {n} — use ring attention "
                "(use_sp=True) for head counts the all-to-all cannot split")

    def attend(seq, devices):
        # the all-to-all: each rank's sequence shards of its head group
        hl = heads // len(devices)
        outs = []
        for i, dev in enumerate(devices):
            qg, kg, vg = (torch.cat([c[:, :, i * hl:(i + 1) * hl].to(dev)
                                     for c in parts], dim=1)
                          for parts in seq)
            if use_drop:
                outs.append(_single_block_attention(qg, kg, vg, scale,
                                                    causal, rng_key,
                                                    dropout_p))
            else:
                outs.append(attn_mod._reference_attention(qg, kg, vg, None,
                                                          scale, causal))
        return outs

    def over_ranks(parts, devs):
        n = len(devs)
        check(n)
        seq = [[p[j].chunk(n, dim=1)[i] for i, p in enumerate(parts)]
               for j in range(3)]
        outs = attend(seq, devs)
        # back from head shards to sequence shards: the head groups side
        # by side are the global output
        return [torch.cat([o.to(d) for o in outs], dim=2) for d in devs]

    got = _on_rank(mesh, axis, query, key, value, over_ranks,
                   "ulysses_attention")
    if got is not False and got is not None:
        return got
    devices = None if got is None else _sp_devices(mesh, axis)
    if devices is None:
        return _degenerate(query, key, value, scale, causal, dropout_p,
                           rng_key)
    check(len(devices))
    outs = attend([_shards(t, devices) for t in (query, key, value)],
                  devices)
    return torch.cat([o.to(query.device) for o in outs], dim=2)
