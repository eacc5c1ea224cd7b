"""The rank-sharded serving model of the ``(mp, dp)`` mesh.

The JAX engine gets its sharded programs from GSPMD: it places the
tensor-parallel model's weights and the KV pools by their
PartitionSpecs (``SERVING_SPECS``) and lets XLA split every compiled
program (the ragged tick, the XLA decode and verify ticks, each prefill)
and insert the collectives.  There is no such compiler here, so this
module is those derived programs written out, and it has no JAX file of
its own.  One controller drives every rank (see ``distributed/mesh.py``):

* ``ShardedServingModel(tp_model, mesh)`` slices the tensor-parallel
  model's weights by their ``partition_spec`` onto each rank's device —
  heads, FFN columns/rows and vocab rows over mp, everything replicated
  over dp placed once per distinct device.  Over an ``(1, dp)`` mesh it
  also takes a dense model whose block Linears cannot take the
  tensor-parallel form (weight-only int8, ``Engine(weight_dtype=
  "int8")``): each rank then runs the dense block modules, placed once per
  distinct device, as the JAX engine replicates the int8 codes over dp;
* per dp group (its ``B/dp`` slots) and layer, each mp rank computes q/k/v
  for its ``H/mp`` heads and writes K/V into its own pool shard — a paged
  ``[NB/dp, bs, H/mp, hd]`` pool at LOCAL block ids (global id minus the
  shard's first row), or a contiguous ``[B/dp, L, H/mp, hd]`` row pool at
  its LOCAL slot rows — with the write rules of ``models/gpt.py``
  (``window_write_rows`` / ``paged_window_rows`` / ``chunk_write_rows``,
  ``scatter_slot_rows``, ``paged_insert`` for int8 pools); attention runs
  through B4 (``ops.ragged_paged_attn.sharded_ragged_paged_attention``) in
  the ragged tick, per rank through ``slot_attention`` over its gathered
  rows in the XLA ticks and chunks, and through the causal
  ``scaled_dot_product_attention`` in a whole-prompt prefill; each rank's
  partial ``einsum("bshd,hde->bse")`` and ``fc2`` product is summed over
  mp (``all_reduce_sum``) before the bias;
* an MoE block (``distributed.moe.MoELayer``) runs once over the rows of
  every dp group a program covers: their ln2 rows meet on the mesh's
  first device in slot order, the router, capacity and experts
  (replicated: the serving mesh has no ``ep`` axis) see them as GSPMD's
  one program does in the JAX engine, and each group takes its rows back;
* the vocab-parallel embedding reads zeros for ids outside a rank's rows
  and is summed over mp; the column-parallel head's logits are gathered
  over vocab (``all_gather``), and every dp group's rows meet on the
  mesh's first device in slot order, where the sampling epilogue
  (``models.gpt.fused_ragged_tick`` / ``fused_decode_tick`` /
  ``fused_spec_verify_tick``) runs on the full logits with the per-lane
  keys of ``_slot_sample_keys``, or whence host sampling downloads them,
  so a seeded stream does not depend on the mesh.

A prefill covers one slot, so only its dp group runs (``shard=`` names it
where no slot index does).  Nothing in the per-rank programs waits for
the host: on one card the ``.to(dev)`` moves are no-ops, across cards
they are device-to-device copies, so the engine's pipelined loop keeps a
tick in flight over the mesh as over one device.

Pools are per layer a list of rank shards, in the mesh's rank order,
tensors or ``QuantKV`` with scales ``[NB/dp, H/mp]``.  ``gather_blocks``
and ``scatter_blocks`` move whole blocks between those shards and the
global ``[n, bs, H, hd]`` layout (heads joined in mp rank order) of the
JAX package's migration payload and host tier.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch.nn import functional as F

from ..distributed.collective import all_gather, all_reduce_sum
from ..distributed.moe import MoELayer, moe_ffn
from ..distributed.sharding import shard
# the module, not its names: models.gpt imports serving.quant, which
# runs this package's __init__ while models.gpt is still loading
from ..models import gpt as gpt_mod
from ..nn.functional import scaled_dot_product_attention
from ..ops.ragged_paged_attn import sharded_ragged_paged_attention
from .kvcache import check_block_payload, import_blocks
from .quant import QuantKV
from ..nn.layer.base import torch_named_parameters


class ShardedServingModel:
    """A tensor-parallel ``GPTModel`` served over an ``(mp, dp)``
    ``ServingMesh`` (module docstring), or a dense one over an ``(1, dp)``
    mesh.  Holds per-rank weight shards; the model itself is only read at
    construction (and, dense, run)."""

    @torch.no_grad()
    def __init__(self, tp_model, mesh):
        attn0 = tp_model.blocks[0].attn
        # a dense model's block modules, once per distinct device: the
        # (1, dp) form of a model without a tensor-parallel twin
        self.dense = None
        if not attn0.use_mp:
            if mesh.mp > 1:
                raise ValueError(
                    "ShardedServingModel needs the tensor-parallel model "
                    "form: build GPTModel(use_mp=True) or convert a dense "
                    "model with to_tensor_parallel()")
            home = tp_model.head.ln_f.weight.device
            self.dense = {dev: tp_model if dev == home
                          else copy.deepcopy(tp_model).to(dev)
                          for dev in dict.fromkeys(mesh.devices)}
        H = attn0.num_heads
        V = tp_model.embeddings.word_embeddings.weight.shape[0]
        if H % mesh.mp:
            raise ValueError(
                f"num_heads ({H}) must divide by the mesh's mp degree "
                f"({mesh.mp}) — attention shards whole heads")
        if V % mesh.mp:
            raise ValueError(
                f"vocab_size ({V}) must divide by the mesh's mp degree "
                f"({mesh.mp}) — the embedding and head shard vocab rows "
                "evenly")
        self.mesh = mesh
        self.num_heads = H
        self.head_dim = attn0.head_dim
        self.n_layers = len(tp_model.blocks)
        self.max_position = \
            tp_model.embeddings.position_embeddings.weight.shape[0]
        self.vocab_rows = V // mesh.mp          # embedding rows per rank
        self.ln_eps = tp_model.head.ln_f.eps
        # per-rank weight shards by parameter name, in rank order; an axis
        # the serving mesh lacks (an MoE stack's "ep") replicates
        self.w = {name: shard(p.detach(), tuple(
                      a if a in ("mp", "dp") else None
                      for a in getattr(p, "partition_spec", ())), mesh)
                  for name, p in torch_named_parameters(tp_model)}
        # MoE layers: index -> (k, capacity factor)
        self.moe = {j: (blk.mlp.k, blk.mlp.capacity_factor)
                    for j, blk in enumerate(tp_model.blocks)
                    if isinstance(blk.mlp, MoELayer)}

    # -- helpers ----------------------------------------------------------
    def _reduce(self, parts, d):
        """``all_reduce_sum`` over dp group ``d``; the sum by device."""
        group = self.mesh.mp_group(d)
        return dict(zip(group, all_reduce_sum(parts, group)))

    def _ln(self, x, prefix, r):
        w = self.w
        return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"][r],
                            w[f"{prefix}.bias"][r], self.ln_eps)

    def _per_device(self, d, fn):
        """``{device: fn(device, rank)}`` over dp group ``d``'s distinct
        devices, ``rank`` the group's first rank on that device: work
        replicated over mp runs once per device, not once per rank."""
        first = {}
        for m in range(self.mesh.mp):
            first.setdefault(self.mesh.device(m, d), self.mesh.rank(m, d))
        return {dev: fn(dev, r) for dev, r in first.items()}

    def _group_ranks(self, d):
        """``(m, rank, device)`` of dp group ``d``'s ranks."""
        mesh = self.mesh
        return [(m, mesh.rank(m, d), mesh.device(m, d))
                for m in range(mesh.mp)]

    def _embed(self, d, toks, pids):
        """Group ``d``'s embeddings by device: the vocab-parallel word
        embedding (each rank embeds the ids in its rows, zeros elsewhere,
        summed over mp) plus the replicated position embedding."""
        w = self.w
        parts = []
        for m, r, dev in self._group_ranks(d):
            ids = toks.to(dev).long() - m * self.vocab_rows
            inside = (ids >= 0) & (ids < self.vocab_rows)
            emb = F.embedding(torch.clamp(ids, 0, self.vocab_rows - 1),
                              w["embeddings.word_embeddings.weight"][r])
            parts.append(emb * inside[..., None].to(emb.dtype))
        words = self._reduce(parts, d)
        return self._per_device(d, lambda dev, r: words[dev] + F.embedding(
            pids.to(dev), w["embeddings.position_embeddings.weight"][r]))

    def _qkv(self, j, r, h):
        """Rank ``r``'s q, k, v ``[b, s, H/mp, hd]`` of layer ``j`` from its
        ln1 rows ``h``."""
        if self.dense is not None:
            return self.dense[h.device].blocks[j].attn._qkv_step(h)
        w = self.w
        qkv = torch.einsum("bse,ethd->btshd", h,
                           w[f"blocks.{j}.attn.qkv_weight"][r]) \
            + w[f"blocks.{j}.attn.qkv_bias"][r]
        return qkv[:, 0], qkv[:, 1], qkv[:, 2]

    def _attn_out(self, j, d, ctx):
        """Group ``d``'s attention output by device, the bias added: the
        row-parallel output projection's partial products (``ctx`` by
        rank) summed over mp."""
        pre = f"blocks.{j}.attn"
        if self.dense is not None:
            return self._per_device(
                d, lambda dev, r: self.dense[dev].blocks[j].attn._out(ctx[r]))
        w = self.w
        attn = self._reduce(
            [torch.einsum("bshd,hde->bse", ctx[r], w[f"{pre}.out_weight"][r])
             for _, r, _ in self._group_ranks(d)], d)
        return self._per_device(d, lambda dev, r: attn[dev]
                                + w[f"{pre}.out_bias"][r])

    def _mlp_residual(self, j, d, x):
        """Group ``d``'s attention-free half of layer ``j``: ln2, the
        column-parallel fc1 and row-parallel fc2 per rank, the sum over
        mp, the bias and the residual."""
        w = self.w
        pre = f"blocks.{j}"
        h = self._per_device(d, lambda dev, r: self._ln(x[dev], f"{pre}.ln2",
                                                        r))
        if self.dense is not None:
            return self._per_device(d, lambda dev, r: x[dev] + self.dense[
                dev].blocks[j].mlp(h[dev]))
        parts = []
        for _, r, dev in self._group_ranks(d):
            a = F.gelu(F.linear(h[dev], w[f"{pre}.mlp.fc1.weight"][r].t(),
                                w[f"{pre}.mlp.fc1.bias"][r]),
                       approximate="tanh")
            parts.append(F.linear(a, w[f"{pre}.mlp.fc2.weight"][r].t()))
        y = self._reduce(parts, d)
        return self._per_device(d, lambda dev, r: x[dev] + (
            y[dev] + w[f"{pre}.mlp.fc2.bias"][r]))

    def _moe_residual(self, j, xs, groups):
        """The attention-free half of MoE layer ``j`` for dp ``groups`` at
        once (``xs[d]``: group ``d``'s rows by device): ln2 per group, the
        MoE over the groups' rows joined in slot order on the mesh's first
        device, each group's rows back, the residual."""
        mesh, w = self.mesh, self.w
        pre = f"blocks.{j}"
        dev0 = mesh.devices[0]
        rows = torch.cat([
            self._ln(xs[d][mesh.device(0, d)], f"{pre}.ln2",
                     mesh.rank(0, d)).to(dev0)
            for d in groups], dim=0)
        k, cf = self.moe[j]
        out, _ = moe_ffn(rows, *(w[f"{pre}.mlp.{n}"][0] for n in (
            "gate", "experts.w1", "experts.b1", "experts.w2", "experts.b2")),
            k, cf)
        parts = dict(zip(groups, out.chunk(len(groups), dim=0)))
        return {d: self._per_device(d, lambda dev, r: xs[d][dev]
                                    + parts[d].to(dev))
                for d in groups}

    def _layers(self, groups, toks, pids, attend):
        """Every layer over dp ``groups``: ``toks[d]`` / ``pids[d]`` are
        group ``d``'s ids and positions; ``attend(j, q, k, v)`` takes the
        ranks' q / k / v (dicts by rank), writes their K/V and returns
        their attention contexts by rank.  Returns the final hidden
        states, ``{d: {device: [b, s, E]}}``."""
        x = {d: self._embed(d, toks[d], pids[d]) for d in groups}
        for j in range(self.n_layers):
            pre = f"blocks.{j}"
            q, k, v = {}, {}, {}
            for d in groups:
                h = self._per_device(
                    d, lambda dev, r: self._ln(x[d][dev], f"{pre}.ln1", r))
                for _, r, dev in self._group_ranks(d):
                    q[r], k[r], v[r] = self._qkv(j, r, h[dev])
            ctx = attend(j, q, k, v)
            for d in groups:
                attn = self._attn_out(j, d, ctx)
                x[d] = self._per_device(d, lambda dev, r: x[d][dev]
                                        + attn[dev])
                if j not in self.moe:
                    x[d] = self._mlp_residual(j, d, x[d])
            if j in self.moe:
                x = self._moe_residual(j, x, list(groups))
        return x

    def _logits(self, d, x, out_dev, lanes=None):
        """Group ``d``'s logits on ``out_dev``: ln_f and each rank's vocab
        columns of the head (at ``lanes`` [b, K] of each row, or every
        position), gathered over mp."""
        mesh, w = self.mesh, self.w

        def final(dev, r):
            xd = x[dev]
            if lanes is not None:
                idx = lanes.to(dev).long()[:, :, None].expand(
                    -1, -1, xd.shape[-1])
                xd = torch.gather(xd, 1, idx)
            return self._ln(xd, "head.ln_f", r)

        hf = self._per_device(d, final)
        head = w["head.lm_head.weight"]
        parts = [F.linear(hf[dev], head[r] if self.dense is not None
                          else head[r].t())
                 for _, r, dev in self._group_ranks(d)]
        return all_gather(parts, -1, mesh.mp_group(d))[0].to(out_dev)

    def _split(self, t):
        """``t``'s rows by dp group, ``{d: rows}``."""
        bl = t.shape[0] // self.mesh.dp
        return {d: t[d * bl:(d + 1) * bl] for d in range(self.mesh.dp)}

    def _positions(self, pos, W):
        """Positions ``pos[b] + [0, W)``, clamped into the table (the
        clamp only guards lanes nothing reads)."""
        return torch.clamp(
            pos.long()[:, None] + torch.arange(W, device=pos.device)[None],
            max=self.max_position - 1)

    def _tick_logits(self, x, out_dev, lanes=None):
        """Every dp group's logits joined in slot order on ``out_dev``."""
        dp = self.mesh.dp
        parts = [self._logits(d, x[d], out_dev,
                              None if lanes is None else lanes[d])
                 for d in range(dp)]
        return torch.cat(parts, 0) if dp > 1 else parts[0]

    # -- the ragged tick --------------------------------------------------
    @torch.no_grad()
    def _ragged_window_tick_slots(self, toks, k_pools, v_pools,
                                  block_tables, pos, width, scratch=None,
                                  head_lanes=None, variant="stream"):
        """``GPTModel._ragged_window_tick_slots`` over the mesh: the same
        arguments and result, with ``k_pools``/``v_pools`` per layer a
        list of rank shards.  ``toks``, ``pos``, ``width``, the tables and
        ``scratch`` (GLOBAL block ids) cover the whole batch; the logits
        come back on the device ``toks`` lies on."""
        mesh = self.mesh
        dp = mesh.dp
        B, W = toks.shape
        bl = B // dp
        rps, bs = k_pools[0][0].shape[0], k_pools[0][0].shape[1]
        Hl, hd = self.num_heads // mesh.mp, self.head_dim
        if scratch is None:   # each dp shard's scratch block
            scratch = (torch.arange(B, device=toks.device) // bl
                       * rps).int()
        # per (dp group, device): where each lane writes — LOCAL block
        # ids, the same for every layer and mp rank
        rows = {}
        for d in range(dp):
            sl = slice(d * bl, (d + 1) * bl)
            for dev in dict.fromkeys(mesh.mp_group(d)):
                rows[d, dev] = gpt_mod.window_write_rows(
                    block_tables[sl].to(dev) - d * rps, pos[sl].to(dev),
                    width[sl].to(dev), scratch[sl].to(dev) - d * rps, W, bs)

        def attend(j, q, k, v):
            for r, (m, d) in enumerate(mesh.ranks()):
                blk, off = rows[d, mesh.device(m, d)]
                gpt_mod.write_window_kv(
                    k_pools[j][r], v_pools[j][r], k[r].reshape(bl * W, Hl, hd),
                    v[r].reshape(bl * W, Hl, hd), blk, off)
            kv = [gpt_mod.kernel_view(p) for p in k_pools[j]]
            vv = [gpt_mod.kernel_view(p) for p in v_pools[j]]
            quant = kv[0][1] is not None
            ctx = sharded_ragged_paged_attention(
                [q[r] for r in range(mesh.size)], [t for t, _ in kv],
                [t for t, _ in vv], block_tables, pos, width, block_size=bs,
                mesh=mesh, k_scale_shards=[s for _, s in kv] if quant else None,
                v_scale_shards=[s for _, s in vv] if quant else None,
                variant=variant)
            return dict(enumerate(ctx))

        x = self._layers(range(dp), self._split(toks),
                         self._split(self._positions(pos, W)), attend)
        lanes = None if head_lanes is None else self._split(head_lanes)
        return self._tick_logits(x, toks.device, lanes), k_pools, v_pools

    def _fused_ragged_tick_slots(self, toks, k_pools, v_pools, block_tables,
                                 width, mode, lanes, tok, pos, temp, top_k,
                                 top_p, seed_lo, seed_hi, ctr, eos, rem,
                                 scratch=None, emit_w=None,
                                 variant="stream", any_sampling=None,
                                 any_final=None):
        """One engine tick over the mesh: the signature and result of
        ``GPTModel._fused_ragged_tick_slots`` (``models/gpt.py``), pools
        as per-layer lists of rank shards."""
        return gpt_mod.fused_ragged_tick(
            self, toks, k_pools, v_pools, block_tables, width, mode, lanes,
            tok, pos, temp, top_k, top_p, seed_lo, seed_hi, ctr, eos, rem,
            block_size=k_pools[0][0].shape[1], scratch=scratch,
            emit_w=emit_w, variant=variant, any_sampling=any_sampling,
            any_final=any_final)

    # -- the XLA ticks ------------------------------------------------------
    def _contiguous_window(self, toks, k_bufs, v_bufs, pos, in_range):
        """The decode / verify window over contiguous rows: each rank's
        lane j of slot b writes its K/V at ``pos[b] + j`` of the slot's
        LOCAL row in its ``[B/dp, L, H/mp, hd]`` shard
        (``scatter_slot_rows``) and attends over that row
        (``slot_attention``).  Returns logits [B, W, V]."""
        mesh = self.mesh
        pos_g = self._split(pos)

        def attend(j, q, k, v):
            ctx = {}
            for r, (m, d) in enumerate(mesh.ranks()):
                p = pos_g[d].to(mesh.device(m, d))
                kb, vb = k_bufs[j][r], v_bufs[j][r]
                gpt_mod.scatter_slot_rows(kb, p, k[r], in_range)
                gpt_mod.scatter_slot_rows(vb, p, v[r], in_range)
                ctx[r] = gpt_mod.slot_attention(q[r], kb, vb, p)
            return ctx

        x = self._layers(range(mesh.dp), self._split(toks),
                         self._split(self._positions(pos, toks.shape[1])),
                         attend)
        return self._tick_logits(x, toks.device)

    def _paged_window(self, toks, k_pools, v_pools, block_tables, pos):
        """The decode / verify window through block tables: each rank's
        lanes write through the slot's table at LOCAL block ids
        (``paged_window_rows``) and attend over the slot's gathered rows
        of its shard.  Returns logits [B, W, V]."""
        mesh = self.mesh
        B, W = toks.shape
        bl = B // mesh.dp
        rps, bs = k_pools[0][0].shape[0], k_pools[0][0].shape[1]
        Hl, hd = self.num_heads // mesh.mp, self.head_dim
        local = {}
        for d in range(mesh.dp):
            sl = slice(d * bl, (d + 1) * bl)
            for dev in dict.fromkeys(mesh.mp_group(d)):
                t = block_tables[sl].to(dev).long() - d * rps
                p = pos[sl].to(dev)
                local[d, dev] = (t, p, *gpt_mod.paged_window_rows(t, p, W,
                                                                  bs))

        def attend(j, q, k, v):
            ctx = {}
            for r, (m, d) in enumerate(mesh.ranks()):
                t, p, blk, off = local[d, mesh.device(m, d)]
                kp, vp = k_pools[j][r], v_pools[j][r]
                gpt_mod.write_window_kv(kp, vp, k[r].reshape(bl * W, Hl, hd),
                                        v[r].reshape(bl * W, Hl, hd), blk,
                                        off)
                ctx[r] = gpt_mod.slot_attention(
                    q[r], gpt_mod.gather_block_rows(kp, t),
                    gpt_mod.gather_block_rows(vp, t), p)
            return ctx

        x = self._layers(range(mesh.dp), self._split(toks),
                         self._split(self._positions(pos, W)), attend)
        return self._tick_logits(x, toks.device)

    @torch.no_grad()
    def _decode_tick_slots(self, tok, k_bufs, v_bufs, pos, in_range=False):
        """``GPTModel._decode_tick_slots`` over the mesh's contiguous row
        shards.  Returns (last logits [B, V], k_bufs, v_bufs)."""
        return (self._contiguous_window(tok, k_bufs, v_bufs, pos,
                                        in_range)[:, -1], k_bufs, v_bufs)

    @torch.no_grad()
    def _spec_verify_tick_slots(self, toks, k_bufs, v_bufs, pos,
                                in_range=False):
        """``GPTModel._spec_verify_tick_slots`` over the mesh.  Returns
        (logits [B, W, V], k_bufs, v_bufs)."""
        return (self._contiguous_window(toks, k_bufs, v_bufs, pos,
                                        in_range), k_bufs, v_bufs)

    @torch.no_grad()
    def _decode_tick_slots_paged(self, tok, k_pools, v_pools, block_tables,
                                 pos):
        """``GPTModel._decode_tick_slots_paged`` over the mesh's pool
        shards.  Returns (last logits [B, V], k_pools, v_pools)."""
        return (self._paged_window(tok, k_pools, v_pools, block_tables,
                                   pos)[:, -1], k_pools, v_pools)

    @torch.no_grad()
    def _spec_verify_tick_slots_paged(self, toks, k_pools, v_pools,
                                      block_tables, pos):
        """``GPTModel._spec_verify_tick_slots_paged`` over the mesh.
        Returns (logits [B, W, V], k_pools, v_pools)."""
        return (self._paged_window(toks, k_pools, v_pools, block_tables,
                                   pos), k_pools, v_pools)

    def _row_length(self, k_bufs, block_tables):
        return (k_bufs[0][0].shape[1] if block_tables is None
                else block_tables.shape[1] * k_bufs[0][0].shape[1])

    def _fused_decode_tick_slots(self, tok, k_bufs, v_bufs, pos, temp,
                                 top_k, top_p, seed_lo, seed_hi, ctr, eos,
                                 rem, block_tables=None, any_sampling=None,
                                 in_range=False):
        """``GPTModel._fused_decode_tick_slots`` over the mesh: the same
        arguments and result, pools as per-layer lists of rank shards."""
        return gpt_mod.fused_decode_tick(
            self, tok, k_bufs, v_bufs, pos, temp, top_k, top_p, seed_lo,
            seed_hi, ctr, eos, rem, L=self._row_length(k_bufs, block_tables),
            block_tables=block_tables, any_sampling=any_sampling,
            in_range=in_range)

    def _fused_spec_verify_tick_slots(self, toks, k_bufs, v_bufs, pos,
                                      lanes, temp, top_k, top_p, seed_lo,
                                      seed_hi, ctr, eos, rem,
                                      block_tables=None, any_sampling=None,
                                      in_range=False):
        """``GPTModel._fused_spec_verify_tick_slots`` over the mesh."""
        return gpt_mod.fused_spec_verify_tick(
            self, toks, k_bufs, v_bufs, pos, lanes, temp, top_k, top_p,
            seed_lo, seed_hi, ctr, eos, rem,
            L=self._row_length(k_bufs, block_tables),
            block_tables=block_tables, any_sampling=any_sampling,
            in_range=in_range)

    # -- prefill ------------------------------------------------------------
    def _last(self, d, x, n, out_dev):
        """The logits [1, V] at the ``n``-th position (index n - 1,
        clamped as ``dynamic_slice`` clamps) of group ``d``'s one row."""
        S = next(iter(x.values())).shape[1]
        i = min(max(int(n) - 1, 0), S - 1)
        return self._logits(d, {dev: t[:, i:i + 1] for dev, t in x.items()},
                            out_dev)[:, 0]

    def _one_slot(self, d, ids, positions, attend):
        return self._layers([d], {d: ids}, {d: positions[None]}, attend)[d]

    @torch.no_grad()
    def _prefill_slot(self, ids, k_pools, v_pools, slot, true_len=None):
        """``GPTModel._prefill_slot`` over the mesh: the prompt's causal
        forward on slot ``slot``'s dp group, each rank's K/V at positions
        ``[0, S)`` of the slot's LOCAL row in its contiguous shard and
        zeros over the rest.  Returns the last logits [1, V]."""
        d, i = divmod(int(slot), k_pools[0][0].shape[0])
        S = ids.shape[1]

        def attend(j, q, k, v):
            ctx = {}
            for _, r, _ in self._group_ranks(d):
                kp, vp = k_pools[j][r], v_pools[j][r]
                ctx[r] = scaled_dot_product_attention(
                    q[r], k[r], v[r], is_causal=True, training=False)
                kp[i, :S] = k[r][0]
                vp[i, :S] = v[r][0]
                kp[i, S:] = 0
                vp[i, S:] = 0
            return ctx

        x = self._one_slot(d, ids, torch.arange(S, device=ids.device),
                           attend)
        return self._last(d, x, S if true_len is None else true_len,
                          ids.device)

    @torch.no_grad()
    def _prefill_paged(self, ids_tail, k_pools, v_pools, ctx_blocks,
                       tail_blocks, shard=0):
        """``GPTModel._prefill_paged`` over the mesh, on dp group
        ``shard`` (whose pool range holds the GLOBAL ``ctx_blocks`` and
        ``tail_blocks``): each rank attends over its heads of the adopted
        prefix blocks plus the tail, and stores its heads of the tail into
        the fresh blocks.  Returns the last logits [1, V]."""
        d = int(shard)
        rps, bs = k_pools[0][0].shape[0], k_pools[0][0].shape[1]
        s_tail = ids_tail.shape[1]
        ctx_len = ctx_blocks.shape[0] * bs
        dt = self.w["head.ln_f.weight"][0].dtype
        ids = {dev: (ctx_blocks.to(dev).long() - d * rps,
                     tail_blocks.to(dev).long() - d * rps)
               for dev in dict.fromkeys(self.mesh.mp_group(d))}

        def attend(j, q, k, v):
            out = {}
            for _, r, dev in self._group_ranks(d):
                ctx_ids, tail_ids = ids[dev]
                kp, vp = k_pools[j][r], v_pools[j][r]
                kk = torch.cat([gpt_mod.paged_ctx_rows(kp, ctx_ids, dt),
                                k[r]], dim=1)
                vv = torch.cat([gpt_mod.paged_ctx_rows(vp, ctx_ids, dt),
                                v[r]], dim=1)
                out[r] = scaled_dot_product_attention(
                    q[r], kk, vv, is_causal=True, training=False)
                gpt_mod.store_tail_blocks(kp, k[r][0], tail_ids)
                gpt_mod.store_tail_blocks(vp, v[r][0], tail_ids)
            return out

        x = self._one_slot(d, ids_tail, ctx_len + torch.arange(
            s_tail, device=ids_tail.device), attend)
        return self._last(d, x, s_tail, ids_tail.device)

    @torch.no_grad()
    def _chunk_prefill_slot(self, toks, k_pools, v_pools, slot, pos,
                            true_len):
        """``GPTModel._chunk_prefill_slot`` over the mesh: one chunk of C
        tokens at ``pos`` into slot ``slot``'s LOCAL row (the window's
        start clamped so it fits, as ``GPTAttention.decode`` writes it),
        its queries over the whole row.  Returns the last logits [1, V]."""
        d, i = divmod(int(slot), k_pools[0][0].shape[0])
        C = toks.shape[1]
        start = min(max(int(pos), 0), k_pools[0][0].shape[1] - C)
        pos_b = torch.full((1,), int(pos), dtype=torch.long,
                           device=toks.device)

        def attend(j, q, k, v):
            ctx = {}
            for _, r, dev in self._group_ranks(d):
                kb = k_pools[j][r][i:i + 1]
                vb = v_pools[j][r][i:i + 1]
                kb[:, start:start + C] = k[r]
                vb[:, start:start + C] = v[r]
                ctx[r] = gpt_mod.slot_attention(q[r], kb, vb, pos_b.to(dev))
            return ctx

        x = self._one_slot(d, toks, self._positions(pos_b, C)[0], attend)
        return self._last(d, x, true_len, toks.device)

    @torch.no_grad()
    def _chunk_prefill_tick_paged(self, toks, k_pools, v_pools,
                                  block_table, pos, true_len, scratch=0):
        """``GPTModel._chunk_prefill_tick_paged`` over the mesh: the dp
        group is the one whose pool range holds the slot's GLOBAL scratch
        row ``scratch``; each rank writes its heads through the LOCAL
        table (pad lanes into the scratch block) and attends over the
        slot's gathered row.  Returns (last logits [1, V], k_pools,
        v_pools)."""
        rps, bs = k_pools[0][0].shape[0], k_pools[0][0].shape[1]
        d = int(scratch) // rps
        C = toks.shape[1]
        pos_b = torch.full((1,), int(pos), dtype=torch.long,
                           device=toks.device)
        local = {}
        for dev in dict.fromkeys(self.mesh.mp_group(d)):
            t = block_table.to(dev).long() - d * rps
            local[dev] = (t, *gpt_mod.chunk_write_rows(
                t, pos, true_len, int(scratch) - d * rps, C, bs))

        def attend(j, q, k, v):
            ctx = {}
            for _, r, dev in self._group_ranks(d):
                t, blk, off = local[dev]
                kp, vp = k_pools[j][r], v_pools[j][r]
                gpt_mod.write_window_kv(kp, vp, k[r][0], v[r][0], blk, off)
                ctx[r] = gpt_mod.slot_attention(
                    q[r], gpt_mod.gather_block_rows(kp, t[None]),
                    gpt_mod.gather_block_rows(vp, t[None]), pos_b.to(dev))
            return ctx

        x = self._one_slot(d, toks, self._positions(pos_b, C)[0], attend)
        return self._last(d, x, true_len, toks.device), k_pools, v_pools


# -- whole blocks between rank shards and the global layout -----------------
def _by_shard(block_ids, rows_per_shard):
    """``{dp shard: (positions in block_ids, local ids)}``."""
    ids = np.asarray([int(b) for b in block_ids], np.int64)
    out = {}
    for d in np.unique(ids // rows_per_shard):
        at = np.nonzero(ids // rows_per_shard == d)[0]
        out[int(d)] = (at, ids[at] - d * rows_per_shard)
    return out


def gather_blocks(shards, block_ids, mesh, rows_per_shard, device):
    """One layer's K or V rows of GLOBAL blocks ``block_ids`` (at least
    one) from its rank shards, each rank's head slice joined in mp rank
    order: a ``[n, bs, H, hd]`` tensor on ``device`` (block i at row i),
    or a ``QuantKV`` whose scales ``[n, H]`` join the same way."""
    quant = isinstance(shards[0], QuantKV)
    pieces, order = [], []
    for d, (at, local) in _by_shard(block_ids, rows_per_shard).items():
        parts = []
        for m in range(mesh.mp):
            p = shards[mesh.rank(m, d)]
            idx = torch.as_tensor(local, device=p.codes.device if quant
                                  else p.device)
            parts.append((p.codes.index_select(0, idx).to(device),
                          p.scale.index_select(0, idx).to(device))
                         if quant else p.index_select(0, idx).to(device))
        pieces.append(parts)
        order.extend(at.tolist())
    inv = torch.as_tensor(np.argsort(np.asarray(order, np.int64)),
                          device=device)

    def join(get, dim):
        t = torch.cat([torch.cat([get(p) for p in parts], dim=dim)
                       for parts in pieces], dim=0)
        return t.index_select(0, inv)

    if quant:
        return QuantKV(join(lambda p: p[0], 2), join(lambda p: p[1], 1))
    return join(lambda p: p, 2)


def scatter_blocks(k_pools, v_pools, block_ids, data, scales, mesh,
                   rows_per_shard):
    """Write an ``export_blocks`` array of the global layout into GLOBAL
    blocks ``block_ids`` of every layer's rank shards: each rank takes its
    heads of the blocks in its dp shard's range, at their LOCAL ids
    (``kvcache.import_blocks``).  The whole payload is checked against
    the global geometry (``check_block_payload``) before any rank
    writes."""
    p0 = k_pools[0][0]
    Hl = p0.shape[2]
    data, scales = check_block_payload(
        isinstance(p0, QuantKV), len(k_pools),
        (p0.shape[1], Hl * mesh.mp, p0.shape[3]), len(block_ids), data,
        scales)
    for d, (at, local) in _by_shard(block_ids, rows_per_shard).items():
        for m in range(mesh.mp):
            r = mesh.rank(m, d)
            heads = slice(m * Hl, (m + 1) * Hl)
            import_blocks([kp[r] for kp in k_pools],
                          [vp[r] for vp in v_pools], local.tolist(),
                          data[:, :, at, :, heads],
                          None if scales is None else scales[:, :, at, heads])
