"""The rank-sharded serving tick of the ``(mp, dp)`` mesh.

The JAX engine gets its sharded tick from GSPMD: it places the
tensor-parallel model's weights and the KV pools by their
PartitionSpecs (``SERVING_SPECS``) and lets XLA split the compiled
program and insert the collectives.  There is no such compiler here, so
this module is that derived program written out, and it has no JAX file
of its own.  One controller drives every rank (see
``distributed/mesh.py``):

* ``ShardedServingModel(tp_model, mesh)`` slices the tensor-parallel
  model's weights by their ``partition_spec`` onto each rank's device —
  heads, FFN columns/rows and vocab rows over mp, everything replicated
  over dp placed once per distinct device;
* per dp group (its ``B/dp`` slots) and layer, each mp rank computes q/k/v
  for its ``H/mp`` heads and writes K/V into its own pool shard at LOCAL
  block ids (the width mask and per-slot scratch rule of
  ``models/gpt.py``, ``paged_insert`` for int8 pools); attention runs
  through B4 (``ops.ragged_paged_attn.sharded_ragged_paged_attention``);
  each rank's partial ``einsum("bshd,hde->bse")`` and ``fc2`` product is
  summed over mp (``all_reduce_sum``) before the bias;
* an MoE block (``distributed.moe.MoELayer``) runs once over the whole
  batch: every dp group's ln2 rows meet on the mesh's first device in
  slot order, the router, capacity and experts (replicated: the serving
  mesh has no ``ep`` axis) see the global window as GSPMD's one program
  does in the JAX engine, and each group takes its rows back;
* the vocab-parallel embedding reads zeros for ids outside a rank's rows
  and is summed over mp; the column-parallel head's logits are gathered
  over vocab (``all_gather``), and every dp group's rows meet on the
  mesh's first device, where the sampling epilogue
  (``models.gpt.fused_ragged_tick``) runs on the full logits with the
  per-lane keys of ``_slot_sample_keys``, so a seeded stream does not
  depend on the mesh.

Nothing in the per-rank window waits for the host: on one card the
``.to(dev)`` moves are no-ops, across cards they are device-to-device
copies, so the engine's pipelined loop keeps a tick in flight over the
mesh as over one device.

Pools are per layer a list of rank shards, in the mesh's rank order:
``[NB/dp, bs, H/mp, hd]`` tensors or ``QuantKV`` with scales
``[NB/dp, H/mp]``.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ..distributed.collective import all_gather, all_reduce_sum
from ..distributed.moe import MoELayer, moe_ffn
from ..distributed.sharding import shard
# the module, not its names: models.gpt imports serving.quant, which
# runs this package's __init__ while models.gpt is still loading
from ..models import gpt as gpt_mod
from ..ops.ragged_paged_attn import sharded_ragged_paged_attention


class ShardedServingModel:
    """A tensor-parallel ``GPTModel`` served over an ``(mp, dp)``
    ``ServingMesh`` (module docstring).  Holds per-rank weight shards; the
    model itself is only read at construction."""

    @torch.no_grad()
    def __init__(self, tp_model, mesh):
        attn0 = tp_model.blocks[0].attn
        if not attn0.use_mp:
            raise ValueError(
                "ShardedServingModel needs the tensor-parallel model form: "
                "build GPTModel(use_mp=True) or convert a dense model with "
                "to_tensor_parallel()")
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
                  for name, p in tp_model.named_parameters()}
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

    def _embed(self, d, rows):
        """Group ``d``'s embeddings by device: the vocab-parallel word
        embedding (each rank embeds the ids in its rows, zeros elsewhere,
        summed over mp) plus the replicated position embedding."""
        mesh, w = self.mesh, self.w
        parts = []
        for m in range(mesh.mp):
            r = mesh.rank(m, d)
            ids = rows[d, mesh.device(m, d)]["toks"].long() \
                - m * self.vocab_rows
            inside = (ids >= 0) & (ids < self.vocab_rows)
            emb = F.embedding(torch.clamp(ids, 0, self.vocab_rows - 1),
                              w["embeddings.word_embeddings.weight"][r])
            parts.append(emb * inside[..., None].to(emb.dtype))
        words = self._reduce(parts, d)
        return self._per_device(d, lambda dev, r: words[dev] + F.embedding(
            rows[d, dev]["pids"],
            w["embeddings.position_embeddings.weight"][r]))

    def _mlp_residual(self, j, d, x):
        """Group ``d``'s attention-free half of layer ``j``: ln2, the
        column-parallel fc1 and row-parallel fc2 per rank, the sum over
        mp, the bias and the residual."""
        mesh, w = self.mesh, self.w
        pre = f"blocks.{j}"
        h = self._per_device(d, lambda dev, r: self._ln(x[dev], f"{pre}.ln2",
                                                        r))
        parts = []
        for m in range(mesh.mp):
            r = mesh.rank(m, d)
            a = F.gelu(F.linear(h[mesh.device(m, d)],
                                w[f"{pre}.mlp.fc1.weight"][r].t(),
                                w[f"{pre}.mlp.fc1.bias"][r]),
                       approximate="tanh")
            parts.append(F.linear(a, w[f"{pre}.mlp.fc2.weight"][r].t()))
        y = self._reduce(parts, d)
        return self._per_device(d, lambda dev, r: x[dev] + (
            y[dev] + w[f"{pre}.mlp.fc2.bias"][r]))

    def _moe_residual(self, j, xs):
        """Every dp group's attention-free half of MoE layer ``j`` at once
        (``xs[d]``: group ``d``'s rows by device): ln2 per group, the MoE
        over the groups' rows joined in slot order on the mesh's first
        device, each group's rows back, the residual."""
        mesh, w = self.mesh, self.w
        pre = f"blocks.{j}"
        dev0 = mesh.devices[0]
        rows = torch.cat([
            self._ln(xs[d][mesh.device(0, d)], f"{pre}.ln2",
                     mesh.rank(0, d)).to(dev0)
            for d in range(mesh.dp)], dim=0)
        k, cf = self.moe[j]
        out, _ = moe_ffn(rows, *(w[f"{pre}.mlp.{n}"][0] for n in (
            "gate", "experts.w1", "experts.b1", "experts.w2", "experts.b2")),
            k, cf)
        parts = out.chunk(mesh.dp, dim=0)
        return [self._per_device(d, lambda dev, r: xs[d][dev]
                                 + parts[d].to(dev))
                for d in range(mesh.dp)]

    # -- the tick ---------------------------------------------------------
    @torch.no_grad()
    def _ragged_window_tick_slots(self, toks, k_pools, v_pools,
                                  block_tables, pos, width, scratch=None,
                                  head_lanes=None, variant="stream"):
        """``GPTModel._ragged_window_tick_slots`` over the mesh: the same
        arguments and result, with ``k_pools``/``v_pools`` per layer a
        list of rank shards.  ``toks``, ``pos``, ``width``, the tables and
        ``scratch`` (GLOBAL block ids) cover the whole batch; the logits
        come back on the device ``toks`` lies on."""
        mesh, w = self.mesh, self.w
        mp, dp = mesh.mp, mesh.dp
        B, W = toks.shape
        bl = B // dp
        rps, bs = k_pools[0][0].shape[0], k_pools[0][0].shape[1]
        Hl, hd = self.num_heads // mp, self.head_dim
        pids = torch.clamp(
            pos.long()[:, None] + torch.arange(W, device=toks.device)[None],
            max=self.max_position - 1)
        if scratch is None:   # each dp shard's scratch block
            scratch = (torch.arange(B, device=toks.device) // bl
                       * rps).int()
        # per (dp group, device): the group's rows, and where each lane
        # writes — LOCAL block ids, the same for every layer and mp rank
        rows = {}
        for d in range(dp):
            sl = slice(d * bl, (d + 1) * bl)
            for dev in dict.fromkeys(mesh.mp_group(d)):
                blk, off = gpt_mod.window_write_rows(
                    block_tables[sl].to(dev) - d * rps, pos[sl].to(dev),
                    width[sl].to(dev), scratch[sl].to(dev) - d * rps, W, bs)
                rows[d, dev] = dict(toks=toks[sl].to(dev),
                                    pids=pids[sl].to(dev), blk=blk, off=off)
        x = [self._embed(d, rows) for d in range(dp)]
        for j in range(self.n_layers):
            pre = f"blocks.{j}"
            h = [self._per_device(
                d, lambda dev, r: self._ln(x[d][dev], f"{pre}.ln1", r))
                for d in range(dp)]
            # each rank: q/k/v of its heads, K/V into its pool shard
            q_shards = []
            for r, (m, d) in enumerate(mesh.ranks()):
                dev = mesh.device(m, d)
                qkv = torch.einsum("bse,ethd->btshd", h[d][dev],
                                   w[f"{pre}.attn.qkv_weight"][r]) \
                    + w[f"{pre}.attn.qkv_bias"][r]
                gpt_mod.write_window_kv(
                    k_pools[j][r], v_pools[j][r],
                    qkv[:, 1].reshape(bl * W, Hl, hd),
                    qkv[:, 2].reshape(bl * W, Hl, hd),
                    rows[d, dev]["blk"], rows[d, dev]["off"])
                q_shards.append(qkv[:, 0])
            kv = [gpt_mod.kernel_view(p) for p in k_pools[j]]
            vv = [gpt_mod.kernel_view(p) for p in v_pools[j]]
            quant = kv[0][1] is not None
            ctx = sharded_ragged_paged_attention(
                q_shards, [k for k, _ in kv], [v for v, _ in vv],
                block_tables, pos, width, block_size=bs, mesh=mesh,
                k_scale_shards=[s for _, s in kv] if quant else None,
                v_scale_shards=[s for _, s in vv] if quant else None,
                variant=variant)
            # the row-parallel output projection: partial products summed
            # over mp, then the bias and the residual
            for d in range(dp):
                attn = self._reduce(
                    [torch.einsum("bshd,hde->bse", ctx[r],
                                  w[f"{pre}.attn.out_weight"][r])
                     for r in (mesh.rank(m, d) for m in range(mp))], d)
                x[d] = self._per_device(d, lambda dev, r: x[d][dev] + (
                    attn[dev] + w[f"{pre}.attn.out_bias"][r]))
                if j not in self.moe:
                    x[d] = self._mlp_residual(j, d, x[d])
            if j in self.moe:
                x = self._moe_residual(j, x)
        # the column-parallel head: each rank's vocab columns, gathered
        # over mp; the dp groups' rows meet on the batch's device
        logits = []
        for d in range(dp):
            lanes = (None if head_lanes is None
                     else head_lanes[d * bl:(d + 1) * bl].long())

            def final(dev, r):
                xd = x[d][dev]
                if lanes is not None:
                    idx = lanes.to(dev)[:, :, None].expand(-1, -1,
                                                          xd.shape[-1])
                    xd = torch.gather(xd, 1, idx)
                return self._ln(xd, "head.ln_f", r)

            hf = self._per_device(d, final)
            parts = [F.linear(hf[mesh.device(m, d)],
                              w["head.lm_head.weight"][mesh.rank(m, d)].t())
                     for m in range(mp)]
            logits.append(all_gather(parts, -1, mesh.mp_group(d))[0]
                          .to(toks.device))
        out = torch.cat(logits, 0) if dp > 1 else logits[0]
        return out, k_pools, v_pools

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
