#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # one card
    python3 chip_smoke.py --cards 4  # the mesh serve over four cards

Without arguments it needs one card and runs these phases, in order; any
failure ends the run with a non-zero exit code and without the last
line:

1. Device: a CUDA card must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel under ``paddle_tpu_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, all at once) and prints
   ptxas's register / shared-memory / spill report (every instantiation:
   the ragged source's stream and gather bodies alike), and for each flash
   kernel the tensor-core instructions in its SASS (``HGMMA`` for wgmma,
   ``HMMA`` for mma.sync; ``cuobjdump -sass``, the toolkit's or the copy
   in Triton's package; "cuobjdump not found" when neither exists): the
   bf16 forward, dK/dV and dQ kernels of ``flash_attention_sm90.cu`` beside
   the scalar ones.
3. Kernels against their plain versions at gpt2-medium's shapes on the
   serving path (H=16, hd=64, block 16, 8 slots, a 64-lane window, 64
   table entries, 513 pool blocks), with decode lanes, prefill-chunk
   lanes, a parked slot and a horizon at the table's last block: fp32
   at atol 2e-6 / rtol 2e-5 (summation order), bf16 at 2e-2 / 2e-2
   against the plain version in f32 on the same bf16 values (bf16
   rounding of the output); lanes past width exactly 0.  Times the
   kernel, the plain version and ``scaled_dot_product_attention`` (the
   library yardstick, over pre-gathered rows; the port never calls it)
   with CUDA events, computes the bound, and prints the split walk's
   pieces (the grid's, and the live ones the inputs need).
4. The slice at full width: ``GPTModel.from_config("gpt2-medium")`` in
   fp32 from a seed, ``Engine(num_slots=8, max_seq_len=1024,
   kv_block_size=16, prefill_chunk=64)``, 12 requests (prompts of 17 to
   900 tokens, four sharing a 48-token system prompt, ten greedy and two
   seeded), ``run_until_idle()``.  Checks: every greedy token is the
   argmax of the dense forward over prompt + output (teacher forcing;
   near ties under a 1e-4 margin are counted, not failed), the kernel
   launched exactly 24 times per ragged dispatch, prefix hits > 0, and
   the seeded streams repeat on a second engine.  A third run of the
   same traffic with ticks 32-55 under ``torch.profiler`` prints the
   device's busy share in that window and the kernels that take the most
   device time (every profiled serve covers the same window: the trace
   of a whole serve takes minutes to process).
5. Flash kernels against their plain versions (``ops/flash_attention.py``):
   the training slice's shape (B=4, H=16, S=2048, hd=128, bf16,
   causal), an fp32 case, an hd=64 case and a case with segment ids
   (four packed documents of uneven lengths).  bf16 runs the
   tensor-core kernels (``csrc/flash_attention_sm90.cu``), fp32 the scalar
   ones (``csrc/flash_attention.cu``).  fp32 holds o
   and lse at atol 1e-5 and the gradients at atol 1e-4 (summation
   order); bf16 holds every output at rtol 2e-2 / atol 2e-2 against the
   plain version computed in f32 from the same bf16 values (bf16
   rounding of the outputs, and of P and dS before their products, as
   the TPU kernel rounds them); every case also holds each output to a
   relative L2 error of 1e-2, which a small but systematic fault on the
   late causal rows (where o is ~0.03 in size) would pass per element
   but not in norm.  At the slice's shape it times the forward, dK/dV and dQ
   kernels, their plain versions and ``scaled_dot_product_attention``
   (is_causal; forward, and backward through autograd — the library
   yardstick; the port never calls it) with CUDA events, and computes
   each kernel's bound from causal FLOPs and bytes.  It also times the
   fp32 case's kernels (the scalar route).
6. The training slice at full width and depth:
   ``GPTModel.from_config("gpt3-1.3b", dropout=0.1, fused_loss=True)``
   from seed 0 in bf16, ``AdamW(learning_rate=1e-4, weight_decay=0.01)``,
   ``TrainStep``, B=4, S=2048 (ids from numpy seed 0), one warm-up step
   and 5 timed steps on the fixed batch.  Checks: every loss finite; the
   first within 0.1 of ln V + E * 0.02^2 / 2 (uniform logits, lifted by
   the N(0, 0.02^2) head weights over unit-variance ln_f outputs); the
   loss falls; each flash kernel launched 24 times per step.  Prints
   tokens/s, seconds a step, peak memory, and a ``torch.profiler``
   breakdown of one more step (device time by kernel, busy share).
7. Kernel path against plain path in the model: gpt3-1.3b at 2 layers,
   B=1, S=2048, bf16, dropout 0; one forward + backward of the loss
   through the kernels and through the plain versions.  The losses
   agree to rtol 1e-3 and every gradient to a relative L2 error of
   2e-2 (bf16 rounding of the attention outputs and gradients,
   propagated through two layers).
8. Quantized and gather kernels against their plain versions, on phase
   3's inputs (the int8 pools are ``quantize_blocks`` of its f32 pools):
   B2 (``ragged_paged_attention_int8``) and B3 (``ragged_gather_attention``)
   over fp and int8 pools, fp32 q at atol 2e-6 / rtol 2e-5 (the
   dequantization is exact in f32, so only the summation order differs),
   bf16 q at 2e-2 / 2e-2 plus a relative L2 error of 1e-2; lanes past
   width exactly 0.  Times each kernel, its plain version and
   ``scaled_dot_product_attention`` over pre-gathered, pre-dequantized
   rows (the library yardstick, the same call as B1's; the port never
   calls it), and computes the bounds from bytes: B2's live codes and
   scales, B3's every gathered table entry (its live-bytes bound printed
   beside it).  Prints each body's split walk (B3's every piece of a slot
   with a real lane).
9. Weight-only int8 slice: phase 4's traffic on a fresh gpt2-medium from
   seed 0 served by ``Engine(weight_dtype="int8")``; every greedy token
   teacher-forced against the dense forward of the same relayouted
   model, as phase 4; B1 launched 24 times a dispatch.
10. int8 KV + int8 weights slice at full width and depth: the same
   traffic through ``Engine(kv_dtype="int8", weight_dtype="int8")`` on
   another fresh model.  Checks: B2 launched 24 times a dispatch and B1
   and B3 not at all, ``QuantKV`` pools, prefix hits > 0, seeded streams
   repeat on a second engine, and the greedy streams equal those of the
   same engine with B2 swapped for its plain version, except from a
   first divergence where the logits that engine picked the token from
   have a top-2 margin under 1e-3 (counted and printed, with the dense
   fp forward's margin beside it: an int8 near tie is one of the int8
   logits, which differ from the dense ones by the KV quantization).
   Prints the greedy agreement with phase 9's streams (the effect of int8
   KV; not gated), tokens/s, and a ``torch.profiler`` busy share and top
   kernels.
11. Gather slices: the same traffic through
   ``Engine(attn_impl="ragged_gather")`` on phase 4's fp32 model
   (teacher-forced as phase 4) and with ``kv_dtype="int8"`` on phase
   10's model (greedy streams equal phase 10's under the same int8
   margin rule).  In both, B3 launched 24 times a dispatch and
   ``kv_blocks_walked`` = 64 x the slots dispatched, summed over
   dispatches.
12. Capacity: ``Engine(kv_budget_mb=1536)`` on gpt2-medium with fp32 and
   with int8 pools; prints both block counts and holds their ratio to
   at least 3.9 (the geometry gives 3.98).
13. B4 (``sharded_ragged_paged_attention``) on a (2, 2) mesh whose four
   ranks all map onto ``cuda:0``: phase 3's inputs with the pool laid out
   in two dp ranges of 257 blocks (each led by its scratch block, every
   slot's blocks in its own range, tables of GLOBAL ids), q and the pools
   sharded per rank.  Over B1, B2 (int8 pools) and B3 (fp and int8
   pools): one launch for the card's group of four ranks, equal to the
   unsharded kernel on the same logical inputs within 1e-6 (each (slot,
   head) runs the same pieces in the same order, so bitwise is expected)
   and to B4's plain form at atol 2e-6 / rtol 2e-5; lanes past width
   exactly 0.  Times the call (CUDA events; the wrapper's host work
   included), its kernel's device time (torch.profiler), the unsharded
   kernel, the plain form and SDPA over each rank's pre-gathered rows (the
   four calls summed); the bound is the unsharded call's.
14. Mesh serving: phase 4's fp32 model -> ``to_tensor_parallel()`` ->
   ``Engine(mesh=ServingMesh(2, 2, devices=[cuda:0] * 4))``, phase 4's
   traffic served three ways.  fp32 pools: every greedy token
   teacher-forced against the dense forward (phase 4's near-tie rule),
   seeded streams equal to phase 4's unsharded ones and repeating on a
   second run profiled as phase 4's (busy share, top kernels, and the
   device time under B4's and the collectives' profiler labels).  int8 pools: greedy
   streams equal to an unsharded ``kv_dtype="int8"`` engine's on the
   same fp32 weights except at int8 near ties (phase 10's rule, margin
   < 1e-3 on the mesh engine's own logits).  Gather body: greedy streams
   equal to the mesh fp32 ones except at near ties (margin < 1e-4 on its
   own logits).  In each, the path's kernel and B4 launched 24 times a
   dispatch (one launch for the card's group of ranks), and no other
   ragged kernel.
15. Pipelined, speculative and preempted serving, on phase 4's fp32
   model and traffic.  Every serve above runs at the engine's default
   ``async_depth=2`` (tick N+1 dispatched before tick N is consumed).
   A/B of depth: fp32 serves at ``async_depth`` 1, 2, 2, 1, each printing
   tokens/s and the loop's mean ``serving.tick_overlap_ms`` /
   ``serving.d2h_wait_ms``; every stream, greedy and seeded, equal
   across depths and to phase 4's (the greedy ones the dense argmax),
   then ``profile_phase`` windows at depth 2 and 1 (busy share, kernels
   a tick).  Each serve's line adds the tracer's host-side means:
   tick, dispatch (the host issuing a tick's launches), emit.
   Sync-free dispatch: the traffic once more, every tick that starts
   with clean state and can admit nothing run under
   ``torch.cuda.set_sync_debug_mode("error")`` (at least 20, one with a
   sampling lane and one with a final-chunk lane among them; the
   consume's wait on its event lifted out).  Speculative decoding:
   ``spec_k=3`` with prompt lookup, B1 launched 24 times a dispatch,
   greedy streams equal phase 4's except at near ties of the engine's
   own logits (margin < 1e-4), the acceptance metrics printed.
   Preemption: on one slot, a priority-0 stream preempted by a
   priority-5 request; ``serving.preemptions_total`` >= 1 and the
   resumed stream equal to the request served alone (dense near ties
   excepted).  The mesh: phase 14's (2, 2) fp32 serve again at depth 1,
   every stream equal to the depth-2 one.
16. The XLA and monolithic paths, on phase 4's fp32 model and traffic,
   served five ways: (a) ``Engine(attn_impl="xla")`` over contiguous
   slot rows with whole-prompt prefill (``kv_block_size=None,
   prefill_chunk=None``: the JAX engine's default configuration); (b)
   the XLA windows over 16-token blocks with 64-token chunks; (c) the
   ragged kernel's decode after a monolithic paged prefill; (d) (a) at
   ``spec_k=3``; (e) (a) with ``sample_mode="host", async_depth=1``.
   Checks: every greedy token the dense argmax (phase 4's near-tie rule),
   the greedy streams equal to phase 4's except from a first divergence
   at a dense near tie (margin < 1e-4), device-mode seeded streams equal
   to phase 4's except where the draw is shown to sit within 1e-4 of a
   cumulative edge between the two tokens, host-mode streams repeating on
   a second engine, prefix hits > 0 in (b) and (c), no ragged kernel in
   (a), (b), (d), (e) and B1 launched 24 times a ragged dispatch in (c),
   no flash kernel; then the sync-free check over (a)'s clean ticks and a
   ``profile_phase`` window of (a) (busy share, kernels a tick).  (f)
   ``gpt3-1.3b`` in bf16 from seed 0 through ``Engine(num_slots=2,
   max_seq_len=2048, attn_impl="xla", prefill_buckets="pow2")``: two
   greedy prompts of 1100 and 1500 tokens pad to the 2048 bucket, so each
   prefill runs B5a once a layer (24 launches a prefill, checked); each
   first token is the dense forward's argmax (near ties under a 5e-2
   margin counted, bf16); prints the prefills' wall times.
17. Generation, draft models, adapters, the host tier and streaming on
   phase 4's fp32 model: (a) ``GPTModel.generate`` of two
   256-token prompts, 64 new tokens, in the four modes (eager,
   ``compiled=True``, ``"fused"``, ``"speculative"``): every greedy token
   the dense argmax (phase 4's near-tie rule), every mode's rows equal the
   eager ones except at a dense near tie, a seeded fused run repeating;
   wall time, tokens/s and ``last_spec_forwards`` printed.  (b) phase 4's
   traffic at ``spec_k=3`` drafted by ``DraftModelProposer`` over an fp32
   copy of the target (every greedy draft lane the served stream's token,
   dense near ties excepted; streams equal phase 4's, near ties and
   near-edge seeded draws excepted), then by the copy at
   ``weight_dtype="int8"`` on the first 6 requests.  (c) LoRA: adapters
   "a" (rank 8) and "b" (rank 16), ``max_adapters=4``, the 12 requests
   spread over base, "a" and "b": adapter streams teacher-forced against
   ``merge_into`` copies, base streams equal phase 4's; mid-serve a third
   adapter loads and serves a 13th request, and unloading a pinned
   adapter is refused; the same traffic at ``attn_impl="xla"`` equal to
   the ragged run; a ``profile_phase`` window.  (d) the host-RAM tier, a
   96-block pool and ``kv_host_mb=2048``, fp32 and int8 KV: three waves
   (cache four prompts, evict them with four others, serve the first four
   again); demotes, promotes and restored tokens > 0, the restored
   streams equal a ``prefix_cache=False`` engine's except at its own near
   ties (1e-4 fp32, 1e-3 int8).  (e) a ``TokenStream`` yields exactly the
   buffered tokens.  B1 (B2 in (d) int8) launched 24 times a dispatch in
   every ragged serve, none in (c)'s XLA serve; no flash kernel.
18. Migration, the front ends, faults and the fleet, on phase 4's fp32
   model and traffic.  (a) Two ragged engines: every request exported
   from A after 8 tokens (``migrate_out(deliver="return")``, the demands
   registered at submit) and imported by B, every other payload through
   its JSON wire form; the streams equal phase 4's (dense near ties and
   near-edge seeded draws excepted), every block adopted, both pools at
   refcount 0 afterwards, B1 launched 24 times a dispatch of A and B.
   Prints bytes a block, the export's gather + download and the import's
   upload + write a block (wall around a synchronize, best of three), and
   the JSON encode / decode of the longest stream's payload.  A prefix
   exported from A's trie warms a fresh engine (its prefix hits rise, its
   stream equal phase 4's); fp32 blocks into int8 pools raise
   ``KVDtypeMismatch`` and adopt nothing; the same pair with
   ``kv_dtype="int8"`` on phase 10's model: streams equal phase 10's
   except at int8 near ties (margin < 1e-3 on B's own logits), B2 24
   launches a dispatch.  (b) An ``EngineServer``: 12 concurrent ``POST
   /generate``, ids equal phase 4's; a ``RouterServer`` over a
   ``prefill`` and a ``decode`` ``EngineServer`` with
   ``RouterPolicy(disaggregate=True)``: streams equal phase 4's,
   ``router_migrations_total`` 12, routed tokens/s printed beside phase
   4's.  (c) tests/test_faults.py's short storm (its sites and rates;
   the watchdog at 3 s, hangs of 30 s) over a ``spec_k=2`` ragged engine,
   twice with seed 11: every request completes equal to phase 4's stream
   (near ties excepted) or fails with an injected error, the second run
   replays the same fault log, step errors and seeded survivors, the
   pools end at refcount 0; then a ``d2h_hang`` at tick 8 under
   ``watchdog_s=1``: ``WatchdogTimeout``, ``last_flight`` holding the
   ticks in flight, and the engine serving again, equal to phase 4's.
   (d) ``spawn_serving_fleet(2, config="gpt2-medium", device="cuda",
   peers=True)`` behind ``routerd`` (a third process checks that seed 0
   draws this process's weights, exactly); replica 0 gets SIGTERM once it
   holds a live stream: its drain line reports ``lost_tokens=0`` and the
   routed streams equal phase 4's.
19. Prints the ``kernels`` JSON line (B1's launches count phase 4's,
   phase 16 (c)'s, phase 17's and phase 18's in-process serves, B2's
   phase 10's, phase 17 (d)'s and phase 18 (a)'s, B5a's phase 6's and
   phase 16 (f)'s), the card line and
   ``{"ok": true, "device": {...}}`` as the last line.  Each kernel's
   ``library_covers`` names the kernels its ``library_ms`` call does the
   work of: SDPA's one backward call gives dq, dk and dv, so both flash
   backward kernels carry its time.

With ``--depth-ab N`` it builds the kernels and runs only
``depth_ab_phase``: N pairs of the fp32 serve at async_depth 1 and 2.
With ``--cards 4`` it builds the kernels and runs only
``four_card_phase``: the (2, 2) mesh serve over four cards beside the
same mesh on one card, both at the default ``async_depth=2``.

Needs the repository around it: alone in a directory it exits non-zero.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
N_LAYERS = 24                      # gpt2-medium and gpt3-1.3b
FLASH_KERNELS = ("fwd", "bwd_dkv", "bwd_dq")
FLASH_REL_TOL = 1e-2               # relative L2 error of each flash output
# the upstream Pallas kernels (installed jax), reached from
# paddle_tpu/nn/functional/attention.py:92
_UPSTREAM = "jax/experimental/pallas/ops/tpu/flash_attention.py"
FLASH_REPLACES = {"fwd": f"{_UPSTREAM}:589", "bwd_dkv": f"{_UPSTREAM}:941",
                  "bwd_dq": f"{_UPSTREAM}:1287"}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    """The first card's name and power limit, as nvidia-smi gives them
    (every card's, joined with "; ", when there are several)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return "; ".join(out.strip().splitlines())


def cuda_time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3 --------------------------------------------------------------
def kernel_inputs(gen, dp=1):
    """gpt2-medium serving shapes with mixed per-slot pos / width.  With
    ``dp`` > 1 the pool is laid out as a dp mesh's: ``dp`` contiguous
    ranges, each led by its own scratch block, every slot's blocks drawn
    from its dp group's range (tables of GLOBAL ids)."""
    import torch
    B, W, H, hd, bs, nb = 8, 64, 16, 64, 16, 64
    rps = B // dp * nb + 1                # blocks per dp shard
    NB = dp * rps                         # 513 on one shard
    # (pos, width): decode lanes at contexts 1, 1000 and 348, prefill
    # chunks of 64, 17 and 40, a parked slot, a chunk whose horizon is
    # the table's last block
    lanes = [(0, 1), (999, 1), (347, 1), (128, 64), (500, 17), (0, 0),
             (1000, 24), (700, 40)]
    pos = torch.tensor([p for p, _ in lanes], dtype=torch.int32)
    width = torch.tensor([w for _, w in lanes], dtype=torch.int32)
    # every slot its own blocks (all the allocatable ones); the parked
    # slot points at its shard's scratch block
    perm_gen = torch.Generator().manual_seed(0)
    tables = torch.cat([
        (torch.randperm(rps - 1, generator=perm_gen) + 1 + d * rps)
        .view(B // dp, nb) for d in range(dp)]).int()
    for b, (_, w) in enumerate(lanes):
        if not w:
            tables[b] = b // (B // dp) * rps
    dev = "cuda"
    q = torch.randn(B, W, H, hd, generator=gen, device=dev)
    k = torch.randn(NB * bs, H, hd, generator=gen, device=dev)
    v = torch.randn(NB * bs, H, hd, generator=gen, device=dev)
    return (q, k, v, tables.to(dev), pos.to(dev), width.to(dev)), bs


def kernel_bound_ms(args, bs, dtype):
    """Least time for the work: bytes of the live K/V rows read once plus
    q, the output and the per-slot metadata, over the memory rate; or the
    flops of the visible scores and value products over the peak rate —
    the larger of the two."""
    q, k, _, tables, pos, width = args
    B, W, H, hd = q.shape
    item = q.element_size()
    nb = tables.shape[1]
    live_rows = 0
    visible = 0
    for p, w in zip(pos.tolist(), width.tolist()):
        n_live = min(nb, (p + max(w, 1) - 1) // bs + 1)
        live_rows += n_live * bs
        visible += sum(p + s + 1 for s in range(w))
    nbytes = (2 * live_rows * H * hd * item + 2 * q.numel() * item
              + (tables.numel() + pos.numel() + width.numel()) * 4)
    flops = 4 * visible * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sdpa_inputs(args, bs):
    """Pre-gathered [B, H, L, hd] rows and the pos / width mask for the
    library yardstick."""
    import torch
    q, k, v, tables, pos, width = args
    B, W, H, hd = q.shape
    nb = tables.shape[1]
    L = nb * bs
    kb = k.view(-1, bs, H, hd)[tables.long()].reshape(B, L, H, hd)
    vb = v.view(-1, bs, H, hd)[tables.long()].reshape(B, L, H, hd)
    lpos = torch.arange(L, device=q.device)
    spos = torch.arange(W, device=q.device)
    mask = lpos[None, None, :] <= (pos.long()[:, None]
                                   + spos[None, :])[:, :, None]
    return (q.transpose(1, 2).contiguous(),
            kb.transpose(1, 2).contiguous(),
            vb.transpose(1, 2).contiguous(), mask[:, None])


def walk_pieces_text(ragged_mod, args, bs, gather=False):
    """The kernels' split walk at these inputs: paged blocks a piece,
    pieces a table (the grid's second dimension), and the CUDA blocks that
    walk rows out of the grid's, over every head: the stream body's up to
    each slot's horizon, the gather body's every piece of a slot with a
    real lane (a parked slot's first piece writes its zeros)."""
    q, _, _, tables, pos, width = args
    nb, H = tables.shape[1], q.shape[2]
    g, n = ragged_mod.walk_pieces(nb, bs)
    live = sum(1 if not w else n if gather
               else -(-min(nb, (p + max(w, 1) - 1) // bs + 1) // g)
               for p, w in zip(pos.tolist(), width.tolist()))
    return (f"walk pieces: {g} blocks a piece, {n} a table, {live * H} of "
            f"{len(pos) * n * H} blocks live")


def kernel_phase(ragged_mod):
    import torch
    import torch.nn.functional as F
    rpa = ragged_mod.ragged_paged_attention
    ref = ragged_mod.ragged_paged_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    args, bs = kernel_inputs(gen)
    width = args[5].tolist()
    results = {}
    for dtype, tol in (("float32", (2e-5, 2e-6)),
                       ("bfloat16", (2e-2, 2e-2))):
        dt = getattr(torch, dtype)
        a = [t.to(dt) if t.is_floating_point() else t for t in args]
        got = rpa(*a, block_size=bs)
        torch.cuda.synchronize()
        a32 = [t.float() if t.is_floating_point() else t for t in a]
        want = ref(*a32, block_size=bs)
        err = 0.0
        for b, w in enumerate(width):
            torch.testing.assert_close(got[b, :w].float(), want[b, :w],
                                       rtol=tol[0], atol=tol[1])
            check(bool(torch.all(got[b, w:] == 0)),
                  f"{dtype}: lanes past width {w} of slot {b} not zero")
            if w:
                err = max(err, float((got[b, :w].float()
                                      - want[b, :w]).abs().max()))
        ms = cuda_time_ms(lambda: rpa(*a, block_size=bs))
        plain_ms = cuda_time_ms(lambda: ref(*a, block_size=bs), iters=3,
                                warmup=1)
        sq, sk, sv, mask = sdpa_inputs(a, bs)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask))
        bound, bound_by = kernel_bound_ms(a, bs, dtype)
        results[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=bound,
                              bound_by=bound_by)
        print(f"kernel ragged_paged_attention {dtype}: max_abs_err {err:.3e}"
              f" ms {ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms {lib_ms:.4f} "
              f"bound_ms {bound:.4f} ({bound_by}); "
              f"{walk_pieces_text(ragged_mod, a, bs)}", flush=True)
    return results


# -- phase 4 --------------------------------------------------------------
def traffic(vocab):
    """12 requests: prompt lengths over 17..900 from a numpy seed, four
    sharing a 48-token system prompt (two among the first eight admitted,
    two later, so the later ones find it cached), ten greedy, two
    seeded."""
    import numpy as np
    rng = np.random.RandomState(1234)
    lens = rng.randint(17, 901, size=12)
    lens[0], lens[11] = 17, 900
    system = rng.randint(0, vocab, 48)
    reqs = []
    for i, n in enumerate(lens):
        prompt = rng.randint(0, vocab, int(n))
        if i in (1, 5, 9, 10):
            prompt = np.concatenate([system, prompt[:max(int(n) - 48, 1)]])
        kw = {}
        if i in (3, 10):
            kw = dict(temperature=0.8, top_p=0.9, seed=900 + i)
        reqs.append((prompt.astype(np.int32), kw))
    return reqs


def submit_all(model, reqs, engine_cls, **engine_kw):
    """The smoke's engine over ``model`` (``Engine(num_slots=8,
    max_seq_len=1024, kv_block_size=16, prefill_chunk=64)``, any of them
    overridden by ``engine_kw``) with every request queued."""
    ekw = dict(num_slots=8, max_seq_len=1024, kv_block_size=16,
               prefill_chunk=64)
    ekw.update(engine_kw)
    eng = engine_cls(model, **ekw)
    return eng, [eng.submit(p, max_new_tokens=32, **kw) for p, kw in reqs]


def serve(model, reqs, engine_cls, **engine_kw):
    import torch
    eng, handles = submit_all(model, reqs, engine_cls, **engine_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, [h.result(timeout=1) for h in handles], wall


def teacher_forcing(model, reqs, outs):
    """Every greedy token must be the dense forward's argmax at its
    position; a token whose dense top-2 margin is under 1e-4 is counted
    as a near tie instead.  Returns (checked, near ties)."""
    import torch
    checked, near = 0, 0
    with torch.no_grad():
        for (prompt, kw), ids in zip(reqs, outs):
            if kw:
                continue
            x = torch.tensor(ids[None].astype("int64"), device="cuda")
            logits = model(x)[0, len(prompt) - 1:-1].float()
            top2 = logits.topk(2, dim=-1).values
            gen = x[0, len(prompt):]
            ok = logits.argmax(-1) == gen
            tie = (top2[:, 0] - top2[:, 1]) < 1e-4
            bad = ~ok & ~tie
            if bool(bad.any()):
                raise RuntimeError(
                    f"chip_smoke: greedy token {int(bad.nonzero()[0])} of "
                    f"a {len(prompt)}-token prompt is not the dense argmax")
            near += int((~ok & tie).sum())
            checked += int(gen.numel())
    return checked, near


def slice_phase(card, ragged_mod):
    import torch
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine

    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0)
    check(len(model.blocks) == N_LAYERS, "gpt2-medium has 24 layers")
    reqs = traffic(model.embeddings.word_embeddings.weight.shape[0])
    rpa = ragged_mod.ragged_paged_attention
    rpa.launches = 0
    eng, outs, wall = serve(model, reqs, Engine)
    launches = rpa.launches
    check(launches == eng.ragged_dispatches * N_LAYERS,
          f"kernel launches {launches} != ragged dispatches "
          f"{eng.ragged_dispatches} x {N_LAYERS}")
    check(eng.prefix_hits > 0, "no prefix-cache hit")
    for (p, _), ids in zip(reqs, outs):
        check(len(ids) == len(p) + 32, "a stream is not 32 tokens long")
    checked, near = teacher_forcing(model, reqs, outs)
    gen_tokens = eng.tokens_generated
    print(f"slice gpt2-medium fp32: async_depth {eng.async_depth} ticks "
          f"{eng.ticks} ragged_dispatches "
          f"{eng.ragged_dispatches} generated_tokens {gen_tokens} "
          f"prefill_tokens {eng.prefill_tokens} prefix_hits "
          f"{eng.prefix_hits} prefix_hit_tokens {eng.prefix_hit_tokens} "
          f"kv_blocks_walked {eng.kv_blocks_walked} "
          f"kernel_launches {launches} wall_s {wall:.3f} tokens_per_s "
          f"{gen_tokens / wall:.2f} greedy_checked {checked} near_ties "
          f"{near}{loop_text(eng)} [{card}]", flush=True)
    # the seeded streams repeat on a second engine serving the same
    # traffic (its launches are not the main path's count)
    eng2, outs2, wall2 = serve(model, reqs, Engine)
    for (p, kw), a, b in zip(reqs, outs, outs2):
        if kw:
            check(a.tolist() == b.tolist(),
                  "a seeded stream did not repeat on a second engine")
    greedy_repeat = all(a.tolist() == b.tolist()
                        for (_, kw), a, b in zip(reqs, outs, outs2)
                        if not kw)
    print(f"second engine: seeded streams repeat; greedy streams repeat "
          f"{greedy_repeat}; wall_s {wall2:.3f}", flush=True)
    profile_phase(model, reqs, Engine, card)
    return launches, model, reqs, outs, gen_tokens / wall


# torch.profiler labels of the mesh path (ops/ragged_paged_attn.py,
# distributed/collective.py), and the ragged kernels' names in a profile
MESH_REGIONS = ("sharded_ragged_paged_attention", "mesh.all_reduce_sum",
                "mesh.all_gather")
RAGGED_KERNEL_NAMES = re.compile(r"ragged_(paged|gather)_attn_kernel")


def device_kernels(prof):
    """Kernels with device time in a profile; user annotations (such as
    ``Optimizer.step``) span device time without being kernels and would
    count it twice."""
    return [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def ragged_device_ms(fn, iters=20):
    """Device time of the ragged kernels a call of ``fn`` launches, from
    ``iters`` calls under torch.profiler after one warm-up: what a
    host-bound call's CUDA-event time does not show."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_kernels(prof)
               if RAGGED_KERNEL_NAMES.search(e.key)) / 1e3 / iters


# the ticks a profile covers: (first, count) — a window that mixes
# prefill chunks and decode lanes, the same in every profiled serve;
# profiling a whole serve costs minutes of trace processing
PROFILE_TICKS = (32, 24)


def profile_phase(model, reqs, engine_cls, card, label="",
                  **engine_kw):
    """Where a tick's time goes: the same traffic once more, ticks
    ``PROFILE_TICKS`` under torch.profiler; prints the device's busy
    share of that window's wall time, the kernels that took the most
    device time in it, and the device time of the kernels launched
    under the mesh's profiler labels (B4, the collectives) where the
    path has them.  Profiler overhead stretches the window's wall time;
    the share is of this window.  The serve then runs to its end;
    returns its streams."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    first, count = PROFILE_TICKS
    eng, handles = submit_all(model, reqs, engine_cls, **engine_kw)
    for _ in range(first):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_until_idle()
    outs = [h.result(timeout=1) for h in handles]
    dev = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in dev)
    print(f"profile{label}: ticks {first}-{first + count - 1} of "
          f"{eng.ticks} async_depth {eng.async_depth} wall_s {wall:.3f} "
          f"device_busy_s {busy_ms / 1e3:.3f} busy_share "
          f"{busy_ms / 1e3 / wall:.3f} kernels_per_tick "
          f"{launches / count:.1f} [{card}]", flush=True)
    dev.sort(key=lambda e: -e.self_device_time_total)
    for e in dev[:10]:
        share = 100 * e.self_device_time_total / 1e3 / busy_ms
        print(f"profile{label} kernel: "
              f"{e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d}x {share:5.1f}% {e.key[:90]}", flush=True)
    # a label's host-side row holds the device time of the torch ops
    # under it; the ragged kernels, launched through ctypes, are not
    # among them and are counted by name (on the mesh path every ragged
    # launch is B4's)
    regions = {e.key: (e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.key in MESH_REGIONS and e.device_type.name == "CPU"}
    if regions:
        ragged = sum(e.self_device_time_total for e in dev
                     if RAGGED_KERNEL_NAMES.search(e.key)) / 1e3
        ms, n = regions.pop("sharded_ragged_paged_attention")
        print(f"profile{label} region: sharded_ragged_paged_attention "
              f"{ragged + ms:10.3f} ms device {n:6d}x "
              f"{100 * (ragged + ms) / busy_ms:5.1f}% of busy (its kernels "
              f"{ragged:.3f} ms, torch ops under it {ms:.3f} ms)", flush=True)
        for key, (ms, n) in regions.items():
            print(f"profile{label} region: {key} {ms:10.3f} ms device "
                  f"{n:6d}x {100 * ms / busy_ms:5.1f}% of busy", flush=True)
    return outs


# -- phase 8 --------------------------------------------------------------
REL_L2_TOL = 1e-2                  # relative L2 error of a bf16 output


def quant_pools(k, v, bs):
    """int8 code rows and f32 scales [NB, H] of the f32 pools, and the
    pools those codes dequantize to."""
    from paddle_tpu_torch.serving.quant import (dequantize_blocks,
                                                quantize_blocks)
    rows, H, hd = k.shape
    out = []
    for pool in (k, v):
        codes, scale = quantize_blocks(pool.view(-1, bs, H, hd))
        out.append((codes.view(rows, H, hd), scale,
                    dequantize_blocks(codes, scale).view(rows, H, hd)))
    return out


def quant_bound_ms(args, bs, dtype, gather, scales):
    """Least time for the work, from this run's pos / width: the bytes
    of the K/V blocks the kernel must read (the streaming body the live
    blocks to each slot's horizon, the gather body every table entry of
    each slot with a real lane), their scale rows when int8, q, the
    output and the per-slot metadata, over the memory rate; or the
    flops of the scores and value products it computes over the peak
    rate; the larger."""
    q, k, _, tables, pos, width = args
    B, W, H, hd = q.shape
    nb = tables.shape[1]
    blocks = flops = 0
    for p, w in zip(pos.tolist(), width.tolist()):
        if gather:
            if w:
                blocks += nb
                flops += 4 * w * nb * bs * H * hd
        else:
            blocks += min(nb, (p + max(w, 1) - 1) // bs + 1)
            flops += 4 * sum(p + s + 1 for s in range(w)) * H * hd
    nbytes = (2 * blocks * bs * H * hd * k.element_size()
              + 2 * q.numel() * q.element_size()
              + (tables.numel() + pos.numel() + width.numel()) * 4)
    if scales:
        nbytes += 2 * blocks * H * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def quant_kernel_phase(ragged_mod):
    """B2 and B3 (fp and int8 pools) against their plain versions on
    phase 3's inputs; times and bounds.  Returns {(name, dtype): result}."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    args, bs = kernel_inputs(gen)
    q, k, v, tables, pos, width = args
    (kc, ks, kd), (vc, vs, vd) = quant_pools(k, v, bs)
    w_list = width.tolist()
    rm = ragged_mod
    cases = (
        # name, kernel, plain version, pools, scales, SDPA's pools
        ("ragged_paged_attention_int8", "stream",
         lambda *a, k_scale, v_scale, block_size:
             rm.ragged_paged_attention_int8(*a, k_scale, v_scale,
                                            block_size=block_size),
         rm.ragged_paged_attention_ref, (kc, vc), (ks, vs), (kd, vd)),
        ("ragged_gather_attention", "gather", rm.ragged_gather_attention,
         rm.ragged_gather_attention_ref, (k, v), None, (k, v)),
        ("ragged_gather_attention_int8_pools", "gather",
         rm.ragged_gather_attention, rm.ragged_gather_attention_ref,
         (kc, vc), (ks, vs), (kd, vd)),
    )
    results = {}
    for name, variant, fn, ref, pools, scales, lib_pools in cases:
        sc = {} if scales is None else dict(k_scale=scales[0],
                                            v_scale=scales[1])
        for dtype, tol in (("float32", (2e-5, 2e-6)),
                           ("bfloat16", (2e-2, 2e-2))):
            dt = getattr(torch, dtype)
            qd = q.to(dt)
            kp, vp = (t if t.dtype == torch.int8 else t.to(dt)
                      for t in pools)
            a = (qd, kp, vp, tables, pos, width)
            got = fn(*a, block_size=bs, **sc)
            torch.cuda.synchronize()
            a32 = [t.float() if t.is_floating_point() else t for t in a]
            want = ref(*a32, block_size=bs, **sc)
            err = 0.0
            diff2 = norm2 = 0.0
            for b, w in enumerate(w_list):
                torch.testing.assert_close(got[b, :w].float(), want[b, :w],
                                           rtol=tol[0], atol=tol[1])
                check(bool(torch.all(got[b, w:] == 0)),
                      f"{name} {dtype}: lanes past width {w} of slot {b} "
                      "not zero")
                if w:
                    d = got[b, :w].float() - want[b, :w]
                    err = max(err, float(d.abs().max()))
                    diff2 += float((d * d).sum())
                    norm2 += float((want[b, :w] ** 2).sum())
            rel = (diff2 / norm2) ** 0.5
            check(rel <= REL_L2_TOL, f"{name} {dtype}: relative L2 error "
                  f"{rel:.3e} over {REL_L2_TOL}")
            ms = cuda_time_ms(lambda: fn(*a, block_size=bs, **sc))
            plain_ms = cuda_time_ms(lambda: ref(*a, block_size=bs, **sc),
                                    iters=3, warmup=1)
            sq, sk, sv, mask = sdpa_inputs(
                (qd, lib_pools[0].to(dt), lib_pools[1].to(dt), tables, pos,
                 width), bs)
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask))
            gather = variant == "gather"
            bound, bound_by = quant_bound_ms(a, bs, dtype, gather,
                                             scales is not None)
            live = ""
            if gather:
                live_ms, _ = quant_bound_ms(a, bs, dtype, False,
                                            scales is not None)
                live = f" live_bound_ms {live_ms:.4f}"
            results[name, dtype] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
            pieces = f"; {walk_pieces_text(ragged_mod, a, bs, gather)}"
            print(f"kernel {name} {dtype}: max_abs_err {err:.3e} rel_l2 "
                  f"{rel:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} sdpa_ms "
                  f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}){live}"
                  f"{pieces}", flush=True)
    return results


# -- phase 13 -------------------------------------------------------------
MESH_SHAPE = (2, 2)                # (mp, dp), every rank on cuda:0


def one_card_mesh():
    import torch
    from paddle_tpu_torch.distributed import ServingMesh
    mp, dp = MESH_SHAPE
    return ServingMesh(mp, dp, devices=[torch.device("cuda", 0)] * (mp * dp))


def mesh_kernel_phase(ragged_mod):
    """B4 over B1, B2 and B3 on phase 3's inputs sharded over the (2, 2)
    mesh: one launch for the card's group of four ranks, held to its plain
    form (per-rank plain versions) and to the unsharded kernel on the same
    logical inputs (bitwise expected, gated at 1e-6); times that launch,
    the unsharded kernel, the plain form and SDPA over each rank's
    pre-gathered rows (summed), and computes the bound from the unsharded
    call's bytes.  Returns {case: result}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.distributed import shard, unshard
    rm = ragged_mod
    mesh = one_card_mesh()
    gen = torch.Generator(device="cuda").manual_seed(0)
    args, bs = kernel_inputs(gen, dp=mesh.dp)
    q, k, v, tables, pos, width = args
    (kc, ks, kd), (vc, vs, vd) = quant_pools(k, v, bs)
    qspec, kvspec = ("dp", None, "mp", None), ("dp", "mp", None)
    rps = k.shape[0] // bs // mesh.dp
    bl = q.shape[0] // mesh.dp
    w_list = width.tolist()
    results = {}

    def group_rows(t):   # each rank's slots, in the launch's order
        return torch.cat([t[d * bl:(d + 1) * bl] for _, d in mesh.ranks()])
    for name, variant, pools, scales in (
            ("stream_fp32", "stream", (k, v), None),
            ("stream_int8", "stream", (kc, vc), (ks, vs)),
            ("gather_fp32", "gather", (k, v), None),
            ("gather_int8", "gather", (kc, vc), (ks, vs))):
        sc = {} if scales is None else dict(k_scale=scales[0],
                                            v_scale=scales[1])
        ssc = {} if scales is None else dict(
            k_scale_shards=shard(scales[0], "kv_scale", mesh),
            v_scale_shards=shard(scales[1], "kv_scale", mesh))
        qs = shard(q, qspec, mesh)
        kss, vss = (shard(t, kvspec, mesh) for t in pools)
        b4_args = (qs, kss, vss, tables, pos, width)
        kw = dict(block_size=bs, mesh=mesh, variant=variant, **ssc)
        b4 = lambda: rm.sharded_ragged_paged_attention(*b4_args, **kw)
        plain = lambda: rm.sharded_ragged_paged_attention_ref(*b4_args,
                                                              **kw)
        one = lambda: rm.ragged_paged_attention(
            q, *pools, tables, pos, width, block_size=bs, variant=variant,
            **sc)
        before = rm.sharded_ragged_paged_attention.launches
        got = unshard(b4(), qspec, mesh)
        torch.cuda.synchronize()
        groups = len(rm.card_groups(mesh))
        check(groups == 1 and rm.sharded_ragged_paged_attention.launches
              == before + groups, f"B4 {name}: not one launch for the "
              "card's four ranks")
        want_one = one()
        want_plain = unshard(plain(), qspec, mesh)
        err_one = float((got - want_one).abs().max())
        check(err_one <= 1e-6, f"B4 {name}: {err_one:.3e} from the "
              "unsharded kernel, over 1e-6")
        err = 0.0
        for b, w in enumerate(w_list):
            torch.testing.assert_close(got[b, :w], want_plain[b, :w],
                                       rtol=2e-5, atol=2e-6)
            check(bool(torch.all(got[b, w:] == 0)),
                  f"B4 {name}: lanes past width {w} of slot {b} not zero")
            if w:
                err = max(err, float((got[b, :w]
                                      - want_plain[b, :w]).abs().max()))
        ms = cuda_time_ms(b4)
        device_ms = ragged_device_ms(b4)
        one_ms = cuda_time_ms(one)
        plain_ms = cuda_time_ms(plain, iters=3, warmup=1)
        # SDPA over each rank's rows, gathered through its localized
        # table (dequantized for int8 pools), the four calls summed
        lib_pools = (kd, vd) if scales is not None else (k, v)
        sdpa = []
        for r, (m, d) in enumerate(mesh.ranks()):
            sl = slice(d * bl, (d + 1) * bl)
            heads = slice(m * q.shape[2] // mesh.mp,
                          (m + 1) * q.shape[2] // mesh.mp)
            rows = slice(d * rps * bs, (d + 1) * rps * bs)
            sdpa.append(sdpa_inputs(
                (q[sl, :, heads].contiguous(),
                 lib_pools[0][rows, heads].contiguous(),
                 lib_pools[1][rows, heads].contiguous(),
                 tables[sl] - d * rps, pos[sl], width[sl]), bs))
        lib_ms = cuda_time_ms(lambda: [F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask) for sq, sk, sv, mask in sdpa])
        gather = variant == "gather"
        bound, bound_by = quant_bound_ms(
            (q, *pools, tables, pos, width), bs, "float32", gather,
            scales is not None)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound,
                             bound_by=bound_by, unsharded_ms=one_ms,
                             err_vs_unsharded=err_one, device_ms=device_ms)
        print(f"kernel sharded_ragged_paged_attention {name} mesh "
              f"{MESH_SHAPE} on one card: max_abs_err {err:.3e} (vs plain "
              f"form) vs_unsharded {err_one:.3e} ms {ms:.4f} (1 launch, "
              f"{mesh.size} ranks; its kernel's device time "
              f"{device_ms:.4f}) unsharded_kernel_ms {one_ms:.4f} "
              f"plain_ms {plain_ms:.4f} sdpa_ms {lib_ms:.4f} (4 ranks "
              f"summed) bound_ms {bound:.4f} ({bound_by}); the launch's "
              + walk_pieces_text(rm, (torch.cat(qs), None, None, tables,
                                      group_rows(pos), group_rows(width)),
                                 bs, gather),
              flush=True)
    return results


# -- phases 9 to 12 -------------------------------------------------------
def ragged_counts(ragged_mod):
    return {n: op.launches for n, op in ragged_mod.KERNEL_OPS.items()}


def zero_ragged_counts(ragged_mod):
    for op in ragged_mod.KERNEL_OPS.values():
        op.launches = 0


def check_launches(ragged_mod, eng, kernel, label):
    """The path launched ``kernel`` 24 times a dispatch and no other
    ragged kernel.  Returns its count."""
    counts = ragged_counts(ragged_mod)
    check(counts[kernel] == eng.ragged_dispatches * N_LAYERS,
          f"{label}: {kernel} launched {counts[kernel]} times, not "
          f"{eng.ragged_dispatches} dispatches x {N_LAYERS}")
    others = {n: c for n, c in counts.items() if n != kernel and c}
    check(not others, f"{label}: other ragged kernels launched: {others}")
    return counts[kernel]


def recording_engine(mesh=False):
    """An Engine class that records, for every emitted token, the top-2
    margin of the logits the engine picked it from (a decode window's
    lane j for its j-th token, a final prefill chunk's last lane): the
    engine's own numbers, int8 KV included.  The gaps are taken on the
    device per dispatch and read at that dispatch's consume, in dispatch
    order, so the ring (``async_depth=2``) keeps them apart.  With
    ``mesh`` the sharded tick is patched.  Returns (class, {(prompt
    bytes, generated index): margin}, undo)."""
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.serving.sharded import ShardedServingModel
    margins, pending = {}, []
    # the mesh engine builds its sharded model itself: patch the class
    owner = ShardedServingModel if mesh else GPTModel
    real_tick = owner._ragged_window_tick_slots

    def tick(self, *args, **kw):
        logits, k_pools, v_pools = real_tick(self, *args, **kw)
        top2 = logits.float().topk(2, dim=-1).values
        pending.append(top2[..., 0] - top2[..., 1])      # [B, E + 1]
        return logits, k_pools, v_pools

    class Recording(Engine):
        _gap = None
        _lane = None

        def _consume(self, inf, tr):
            self._gap = pending.pop(0).cpu()
            return super()._consume(inf, tr)

        def _emit_window_lane(self, slot, *args):
            self._lane = 0
            try:
                return super()._emit_window_lane(slot, *args)
            finally:
                self._lane = None

        def _emit(self, slot, tok):
            req = slot.request
            last = self._gap.shape[1] - 1
            lane = last if self._lane is None else self._lane
            margins[req.prompt.tobytes(), len(req.generated)] = float(
                self._gap[slot.index, lane])
            if self._lane is not None:
                self._lane += 1
            return super()._emit(slot, tok)

    owner._ragged_window_tick_slots = tick

    def undo():
        owner._ragged_window_tick_slots = real_tick

    return Recording, margins, undo


def serve_recording_margins(model, reqs, mesh=False, **engine_kw):
    """``serve`` through ``recording_engine``.  Returns (engine, streams,
    wall, {(prompt bytes, generated index): margin})."""
    cls, margins, undo = recording_engine(mesh)
    if mesh:
        engine_kw["mesh"] = one_card_mesh()
    try:
        eng, outs, wall = serve(model, reqs, cls, **engine_kw)
    finally:
        undo()
    return eng, outs, wall, margins


def stream_divergences(model, reqs, outs_a, outs_b, margins_b, margin):
    """Two engines' greedy streams must be equal, except from a first
    divergence at which the logits engine b picked its token from have a
    top-2 margin under ``margin`` (``serve_recording_margins``).  The
    margin is taken on engine b's own path: two int8-KV engines' K/V
    differ in the last bits, a value at a rounding boundary takes
    another int8 code, and that moves the logits by far more than the
    kernels' summation order, so the dense fp forward's margin is no
    measure of an int8 near tie (it is printed beside it, from
    ``model``).  Returns (divergences, engine b's margins at them)."""
    import torch
    gaps = []
    for (prompt, kw), a, b in zip(reqs, outs_a, outs_b):
        a, b = a.tolist(), b.tolist()
        if kw or a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        g = t - len(prompt)
        gap = margins_b[prompt.tobytes(), g]
        with torch.no_grad():
            top2 = model(torch.tensor([a[:t]], device="cuda"))[0, -1] \
                .float().topk(2).values
        print(f"divergence at generated token {g} of a {len(prompt)}-token "
              f"prompt: engine top-2 margin {gap:.3e}, dense fp forward "
              f"margin {float(top2[0] - top2[1]):.3e}", flush=True)
        check(gap < margin,
              f"greedy streams diverge at generated token {g} of a "
              f"{len(prompt)}-token prompt where the engine's top-2 "
              f"margin is {gap:.3e}, not under {margin}")
        gaps.append(gap)
    return len(gaps), gaps


def greedy_agreement(reqs, outs_a, outs_b):
    """Share of generated greedy tokens equal at the same position."""
    same = total = 0
    for (prompt, kw), a, b in zip(reqs, outs_a, outs_b):
        if kw:
            continue
        ga, gb = a[len(prompt):], b[len(prompt):]
        same += int((ga == gb).sum())
        total += len(ga)
    return same / total


def slice_line(label, eng, wall, launches, card, extra=""):
    print(f"slice {label}: async_depth {eng.async_depth} ticks {eng.ticks} "
          f"ragged_dispatches "
          f"{eng.ragged_dispatches} generated_tokens {eng.tokens_generated} "
          f"prefill_tokens {eng.prefill_tokens} prefix_hits "
          f"{eng.prefix_hits} kv_blocks_walked {eng.kv_blocks_walked} "
          f"kernel_launches {launches} wall_s {wall:.3f} tokens_per_s "
          f"{eng.tokens_generated / wall:.2f}{extra}{loop_text(eng)} "
          f"[{card}]", flush=True)


def weight_slice_phase(card, ragged_mod, reqs):
    """Phase 9: weight-only int8 at full width; returns its streams."""
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.quantization import WeightOnlyInt8Linear
    from paddle_tpu_torch.serving import Engine

    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0)
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(model, reqs, Engine, weight_dtype="int8")
    launches = check_launches(ragged_mod, eng, "ragged_paged_attention",
                              "weight-only int8 slice")
    n_int8 = sum(isinstance(m, WeightOnlyInt8Linear)
                 for m in model.modules())
    check(n_int8 == 4 * N_LAYERS, f"{n_int8} int8 Linears, not "
          f"{4 * N_LAYERS}")
    check(eng.prefix_hits > 0, "weight-only int8: no prefix-cache hit")
    for (p, _), ids in zip(reqs, outs):
        check(len(ids) == len(p) + 32, "a stream is not 32 tokens long")
    checked, near = teacher_forcing(model, reqs, outs)
    slice_line("gpt2-medium weight_dtype=int8", eng, wall, launches, card,
               f" int8_linears {n_int8} greedy_checked {checked} "
               f"near_ties {near}")
    del model, eng
    return outs


def int8_slice_phase(card, ragged_mod, reqs, w_outs):
    """Phase 10: int8 KV + int8 weights at full width and depth.  Returns
    (the relayouted model, its streams, B2's launches)."""
    import torch
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.serving.quant import QuantKV

    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0)
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(model, reqs, Engine, kv_dtype="int8",
                            weight_dtype="int8")
    launches = check_launches(ragged_mod, eng, "ragged_paged_attention_int8",
                              "int8 KV + weights slice")
    check(len(eng.k_pools) == N_LAYERS
          and all(isinstance(p, QuantKV) and p.codes.dtype == torch.int8
                  for p in eng.k_pools + eng.v_pools),
          "the int8 engine's pools are not int8 QuantKV")
    check(eng.prefix_hits > 0, "int8 slice: no prefix-cache hit")
    for (p, _), ids in zip(reqs, outs):
        check(len(ids) == len(p) + 32, "a stream is not 32 tokens long")
    agree = greedy_agreement(reqs, outs, w_outs)
    slice_line("gpt2-medium kv_dtype=int8 weight_dtype=int8", eng, wall,
               launches, card, f" kv_blocks {eng.block_pool.managed_blocks}"
               f" greedy_agreement_with_weight_only {agree:.4f}")
    # the model is relayouted now: the engines below serve it as it is
    eng2, outs2, wall2 = serve(model, reqs, Engine, kv_dtype="int8")
    for (p, kw), a, b in zip(reqs, outs, outs2):
        if kw:
            check(a.tolist() == b.tolist(),
                  "int8: a seeded stream did not repeat on a second engine")
    real = ragged_mod.ragged_paged_attention_int8

    def plain(q, k, v, tables, pos, width, k_scale, v_scale, *,
              block_size):
        return ragged_mod.ragged_paged_attention_ref(
            q, k, v, tables, pos, width, block_size=block_size,
            k_scale=k_scale, v_scale=v_scale)

    ragged_mod.ragged_paged_attention_int8 = plain
    try:
        eng3, outs3, wall3, margins3 = serve_recording_margins(
            model, reqs, kv_dtype="int8")
    finally:
        ragged_mod.ragged_paged_attention_int8 = real
    near, gaps = stream_divergences(model, reqs, outs, outs3, margins3,
                                    1e-3)
    same = sum(a.tolist() == b.tolist()
               for (_, kw), a, b in zip(reqs, outs, outs3) if not kw)
    print(f"int8 slice: seeded streams repeat on a second engine (wall_s "
          f"{wall2:.3f}); greedy streams equal to B2's plain version "
          f"{same} of 10, near-tie divergences (int8 margin < 1e-3) {near}"
          f" at margins {gaps} (plain-version wall_s {wall3:.3f})",
          flush=True)
    profile_phase(model, reqs, Engine, card, label=" int8",
                  kv_dtype="int8")
    del eng, eng2, eng3
    return model, outs, launches


def count_dispatched_slots(model):
    """Wrap the model's tick to count the slots each dispatch runs (width
    > 0); returns (counter, undo)."""
    real = model._fused_ragged_tick_slots
    counter = {"slots": 0}

    def tick(*args, **kw):
        counter["slots"] += int((args[4] > 0).sum())
        return real(*args, **kw)

    model._fused_ragged_tick_slots = tick
    return counter, lambda: delattr(model, "_fused_ragged_tick_slots")


def gather_slices_phase(card, ragged_mod, reqs, model_fp, model_q, q_outs):
    """Phase 11: attn_impl="ragged_gather" over fp32 and int8 pools.
    Returns B3's launches summed over both runs."""
    total = 0
    for label, model, kw in (("fp32", model_fp, {}),
                             ("int8", model_q, dict(kv_dtype="int8"))):
        counter, undo = count_dispatched_slots(model)
        zero_ragged_counts(ragged_mod)
        try:
            eng, outs, wall, margins = serve_recording_margins(
                model, reqs, attn_impl="ragged_gather", **kw)
        finally:
            undo()
        launches = check_launches(ragged_mod, eng, "ragged_gather_attention",
                                  f"gather {label} slice")
        total += launches
        check(eng.kv_blocks_walked == 64 * counter["slots"],
              f"gather {label}: kv_blocks_walked {eng.kv_blocks_walked} != "
              f"64 x {counter['slots']} slots dispatched")
        for (p, _), ids in zip(reqs, outs):
            check(len(ids) == len(p) + 32, "a stream is not 32 tokens long")
        if label == "fp32":
            checked, near = teacher_forcing(model, reqs, outs)
            extra = f" greedy_checked {checked} near_ties {near}"
        else:
            near, gaps = stream_divergences(model, reqs, q_outs, outs,
                                            margins, 1e-3)
            same = sum(a.tolist() == b.tolist()
                       for (_, k), a, b in zip(reqs, q_outs, outs) if not k)
            extra = (f" greedy_equal_to_int8_stream_slice {same}/10 "
                     f"near_tie_divergences {near} at int8 margins {gaps}")
        slice_line(f"gpt2-medium attn_impl=ragged_gather {label}", eng,
                   wall, launches, card,
                   f" slots_dispatched {counter['slots']}{extra}")
    return total


def capacity_phase(model_fp, card):
    """Phase 12: the block counts one kv_budget_mb buys, fp32 and int8."""
    import torch
    from paddle_tpu_torch.serving import Engine
    blocks = {}
    for kv in (None, "int8"):
        eng = Engine(model_fp, num_slots=8, max_seq_len=1024,
                     kv_block_size=16, prefill_chunk=64, kv_budget_mb=1536,
                     kv_dtype=kv)
        blocks[kv] = eng.block_pool.managed_blocks
        print(f"capacity kv_budget_mb 1536 kv_dtype {kv or 'float32'}: "
              f"blocks {blocks[kv]} kv_block_bytes {eng.kv_block_bytes} "
              f"kv_scale_bytes {eng.kv_scale_bytes}", flush=True)
        del eng
        torch.cuda.empty_cache()
    ratio = blocks["int8"] / blocks[None]
    check(ratio >= 3.9, f"int8 pools hold {ratio:.3f}x the fp32 blocks, "
          "under 3.9x")
    print(f"capacity ratio int8 / fp32 {ratio:.4f} [{card}]", flush=True)
    return ratio


# -- phase 14 -------------------------------------------------------------
def check_mesh_launches(ragged_mod, eng, kernel, label):
    """The mesh path launched ``kernel`` through B4 once a card group (one
    group on one card, four over four cards), 24 layers a dispatch, and no
    other ragged kernel.  Returns B4's count."""
    groups = len(ragged_mod.card_groups(eng.mesh))
    counts = ragged_counts(ragged_mod)
    want = eng.ragged_dispatches * N_LAYERS * groups
    path = (kernel, "sharded_ragged_paged_attention")
    for name in path:
        check(counts[name] == want,
              f"{label}: {name} launched {counts[name]} times, not "
              f"{eng.ragged_dispatches} dispatches x {N_LAYERS} x {groups} "
              "card groups")
    others = {n: c for n, c in counts.items() if n not in path and c}
    check(not others, f"{label}: other ragged kernels launched: {others}")
    return counts["sharded_ragged_paged_attention"]


def mesh_slice_phase(card, ragged_mod, model_fp, reqs, fp_outs):
    """Phase 14: gpt2-medium -> to_tensor_parallel() -> Engine(mesh=(2, 2)
    on one card), phase 4's traffic served with fp32 pools (B1 under B4),
    int8 pools (B2) and the gather body (B3).  Returns (B4's launches over
    the three serves, the fp32 serve's streams)."""
    import torch
    from paddle_tpu_torch.serving import Engine

    tp = model_fp.to_tensor_parallel()
    total = 0
    # fp32 pools: teacher-forced against the dense forward; seeded
    # streams equal the unsharded engine's (phase 4) and repeat
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(tp, reqs, Engine, mesh=one_card_mesh())
    n = check_mesh_launches(ragged_mod, eng, "ragged_paged_attention",
                            "mesh fp32 serve")
    total += n
    check(eng.prefix_hits > 0, "mesh fp32: no prefix-cache hit")
    for (p, _), ids in zip(reqs, outs):
        check(len(ids) == len(p) + 32, "a stream is not 32 tokens long")
    checked, near = teacher_forcing(model_fp, reqs, outs)
    for (_, kw), a, b in zip(reqs, outs, fp_outs):
        if kw:
            check(a.tolist() == b.tolist(), "mesh: a seeded stream differs "
                  "from the unsharded engine's")
    slice_line(f"gpt2-medium mesh {MESH_SHAPE} fp32", eng, wall, n, card,
               f" kv_blocks {eng.block_pool.managed_blocks} greedy_checked "
               f"{checked} near_ties {near}")
    again = profile_phase(tp, reqs, Engine, card, label=" mesh",
                          mesh=one_card_mesh())
    for (_, kw), a, b in zip(reqs, outs, again):
        if kw:
            check(a.tolist() == b.tolist(),
                  "mesh: a seeded stream did not repeat")
    del eng
    # int8 pools: greedy streams equal the unsharded int8-KV engine's on
    # the same fp32 weights, except at int8 near ties
    _, u_outs, u_wall = serve(model_fp, reqs, Engine, kv_dtype="int8")
    zero_ragged_counts(ragged_mod)
    eng, q_outs, wall, margins = serve_recording_margins(
        tp, reqs, mesh=True, kv_dtype="int8")
    n = check_mesh_launches(ragged_mod, eng, "ragged_paged_attention_int8",
                            "mesh int8 serve")
    total += n
    near, gaps = stream_divergences(model_fp, reqs, u_outs, q_outs, margins,
                                    1e-3)
    same = sum(a.tolist() == b.tolist()
               for (_, kw), a, b in zip(reqs, u_outs, q_outs) if not kw)
    slice_line(f"gpt2-medium mesh {MESH_SHAPE} kv_dtype=int8", eng, wall,
               n, card,
               f" greedy_equal_to_unsharded_int8 {same}/10 "
               f"near_tie_divergences {near} at margins {gaps} "
               f"(unsharded int8 wall_s {u_wall:.3f})")
    del eng
    # the gather body: greedy streams equal the mesh fp32 streams, except
    # at near ties of its own logits
    zero_ragged_counts(ragged_mod)
    eng, g_outs, wall, margins = serve_recording_margins(
        tp, reqs, mesh=True, attn_impl="ragged_gather")
    n = check_mesh_launches(ragged_mod, eng, "ragged_gather_attention",
                            "mesh gather serve")
    total += n
    near, gaps = stream_divergences(model_fp, reqs, outs, g_outs, margins,
                                    1e-4)
    same = sum(a.tolist() == b.tolist()
               for (_, kw), a, b in zip(reqs, outs, g_outs) if not kw)
    slice_line(f"gpt2-medium mesh {MESH_SHAPE} attn_impl=ragged_gather",
               eng, wall, n, card, f" greedy_equal_to_mesh_fp32 {same}/10 "
               f"near_tie_divergences {near} at margins {gaps}")
    del eng, tp
    torch.cuda.empty_cache()
    return total, outs


def four_card_phase(card, ragged_mod):
    """``--cards 4``: the mesh serve of phase 14 (fp32 pools) on the (2, 2)
    mesh over four cards (``serving_mesh``: rank (m, d) on card
    ``2 d + m``) beside the same mesh mapped onto ``cuda:0``, on a fresh
    gpt2-medium from seed 0: both teacher-forced against the dense
    forward, B4 launched 24 times a dispatch for each card group (one
    group on one card, four over four cards), seeded streams equal.
    Prints each card's peak memory."""
    import torch
    from paddle_tpu_torch.distributed import serving_mesh
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    check(torch.cuda.device_count() >= 4, "--cards 4 needs four cards, "
          f"found {torch.cuda.device_count()}")
    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0)
    tp = model.to_tensor_parallel()
    reqs = traffic(model.embeddings.word_embeddings.weight.shape[0])
    streams = {}
    for label, mesh in (("one card", one_card_mesh()),
                        ("four cards", serving_mesh(*MESH_SHAPE))):
        for i in range(4):
            torch.cuda.reset_peak_memory_stats(i)
        zero_ragged_counts(ragged_mod)
        eng, outs, wall = serve(tp, reqs, Engine, mesh=mesh)
        n = check_mesh_launches(ragged_mod, eng, "ragged_paged_attention",
                                f"mesh on {label}")
        checked, near = teacher_forcing(model, reqs, outs)
        peaks = " ".join(f"{torch.cuda.max_memory_allocated(i) / 1e9:.2f}"
                         for i in range(4))
        slice_line(f"gpt2-medium mesh {MESH_SHAPE} fp32 on {label} "
                   f"({', '.join(str(d) for d in mesh.devices)})", eng, wall,
                   n, card,
                   f" greedy_checked {checked} near_ties {near} "
                   f"peak_mem_gb_per_card {peaks}")
        streams[label] = outs
        del eng
    same = sum(a.tolist() == b.tolist() for a, b in
               zip(streams["one card"], streams["four cards"]))
    for (_, kw), a, b in zip(reqs, streams["one card"],
                             streams["four cards"]):
        if kw:
            check(a.tolist() == b.tolist(), "four cards: a seeded stream "
                  "differs from the one-card mesh's")
    print(f"four cards: {same} of {len(reqs)} streams equal to the "
          "one-card mesh's", flush=True)


# -- phase 15 -------------------------------------------------------------
SPEC_K = 3
DEPTH_ROUNDS = (1, 2, 2, 1)        # async_depth of each A/B serve, in turn
PROFILE_DEPTHS = (2, 1)            # and of each profiled window after them


def mean_ms(eng, name):
    """Mean of one of the engine's millisecond histograms."""
    h = eng.registry.get(name)
    return h.sum / h.count if h.count else 0.0


def span_ms(eng, names):
    """Mean duration (ms) of the engine tracer's spans of these names:
    host clock.  A dispatch span times the host issuing one tick's
    launches (nothing in it waits for the device)."""
    durs = [e["dur"] for e in eng.chrome_trace()["traceEvents"]
            if e.get("ph") == "X" and e["name"] in names]
    return sum(durs) / len(durs) / 1e3 if durs else 0.0


# the tracer's dispatch spans: the ragged window's, the XLA tick's
DISPATCH_SPANS = ("decode.ragged_stream", "decode.ragged", "decode.dispatch")


def loop_text(eng):
    """The loop's host-side means: tick wall, the dispatch's launches,
    the consume's wait and emit, the overlapped host work, the stall
    between dispatches."""
    return (f" tick_ms_mean {span_ms(eng, ('tick',)):.4f}"
            f" dispatch_ms_mean "
            f"{span_ms(eng, DISPATCH_SPANS):.4f}"
            f" emit_ms_mean {span_ms(eng, ('decode.emit',)):.4f}"
            f" d2h_wait_ms_mean {mean_ms(eng, 'serving.d2h_wait_ms'):.4f}"
            f" tick_overlap_ms_mean "
            f"{mean_ms(eng, 'serving.tick_overlap_ms'):.4f}"
            f" decode_stall_ms_mean "
            f"{mean_ms(eng, 'serving.decode_stall_ms'):.4f}")


def depth_phase(card, ragged_mod, model, reqs, fp_outs):
    """Phase 15, A/B of the pipeline depth: fp32 serves at async_depth 1
    and 2 in turns (``DEPTH_ROUNDS``), each printing tokens/s and the
    loop's mean overlap and download wait; every stream (greedy and
    seeded) equal across depths and to phase 4's, the greedy ones the
    dense forward's argmax; B1 launched 24 times a dispatch.  Then a
    ``profile_phase`` window at each depth (``PROFILE_DEPTHS``)."""
    from paddle_tpu_torch.serving import Engine
    for depth in DEPTH_ROUNDS:
        zero_ragged_counts(ragged_mod)
        eng, outs, wall = serve(model, reqs, Engine, async_depth=depth)
        launches = check_launches(ragged_mod, eng, "ragged_paged_attention",
                                  f"depth {depth} serve")
        for (_, kw), a, b in zip(reqs, outs, fp_outs):
            check(a.tolist() == b.tolist(),
                  f"async_depth={depth}: a {'seeded' if kw else 'greedy'} "
                  "stream differs from phase 4's depth-2 stream")
        slice_line("gpt2-medium fp32 A/B", eng, wall, launches, card)
        del eng
    checked, near = teacher_forcing(model, reqs, fp_outs)
    print(f"depth A/B: every stream equal across depths; greedy_checked "
          f"{checked} near_ties {near}", flush=True)
    for depth in PROFILE_DEPTHS:
        profile_phase(model, reqs, Engine, card, label=f" depth{depth}",
                      async_depth=depth)


def sync_free_phase(card, model, reqs, fp_outs, label="", **engine_kw):
    """Phase 15, the sync-free dispatch: the traffic served at depth 2,
    every tick that starts with clean state and can admit nothing (the
    ticks that upload nothing) run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    synchronizing call; the consume's one wait on its event is lifted
    out of the check.  At least 20 such ticks, one with a sampling lane
    and (on a path with chunk lanes) one with a final-chunk lane among
    them; the streams equal ``fp_outs``.  ``engine_kw`` picks the path
    (phase 16 runs it over the XLA contiguous path).  A draft-model
    proposer reads its drafts back to the host every tick, so this check
    does not apply to a draft-model serve (phase 17 (b))."""
    import torch
    from paddle_tpu_torch.serving import Engine
    eng, handles = submit_all(model, reqs, Engine, **engine_kw)
    chunks = eng._ragged and eng._chunk is not None
    real_wait = eng._d2h_wait

    def wait_unchecked(stg):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            real_wait(stg)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    real_dispatch = eng._dispatch
    seen = {"ticks": 0, "sampling": 0, "final": 0}
    checking = [False]

    def dispatch(active, plan, tr):
        if checking[0]:
            seen["sampling"] += any(eng._temp[s.index] > 0 for s in active)
            seen["final"] += any(final for _, _, final in plan)
        return real_dispatch(active, plan, tr)

    eng._d2h_wait = wait_unchecked
    eng._dispatch = dispatch
    while not eng.scheduler.idle():
        checking[0] = (not eng._state_dirty and eng._dev_state is not None
                       and (eng.queue.depth() == 0
                            or eng.scheduler.free_count() == 0))
        if not checking[0]:
            eng.step()
            continue
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen["ticks"] += 1
    outs = [h.result(timeout=1) for h in handles]
    check(seen["ticks"] >= 20 and seen["sampling"]
          and (seen["final"] or not chunks),
          f"sync-free check{label} covered too little: {seen}")
    for a, b in zip(outs, fp_outs):
        check(a.tolist() == b.tolist(),
              f"sync-free check{label}: a stream differs from its "
              "reference")
    print(f"sync-free dispatch{label}: {seen['ticks']} of {eng.ticks} "
          "ticks under "
          f"set_sync_debug_mode('error'), {seen['sampling']} with a "
          f"sampling lane, {seen['final']} with a final-chunk lane; no "
          "synchronizing call", flush=True)


def spec_phase(card, ragged_mod, model, reqs, fp_outs):
    """Phase 15, speculative decoding: the traffic at ``spec_k=3`` with
    prompt lookup, depth 2, B1 launched 24 times a dispatch; greedy
    streams equal phase 4's except from a first divergence at a near tie
    of the engine's own logits (margin < 1e-4, ``stream_divergences``).
    Prints the acceptance metrics and tokens/s."""
    zero_ragged_counts(ragged_mod)
    eng, outs, wall, margins = serve_recording_margins(model, reqs,
                                                       spec_k=SPEC_K)
    launches = check_launches(ragged_mod, eng, "ragged_paged_attention",
                              "spec serve")
    for (p, _), ids in zip(reqs, outs):
        check(len(ids) == len(p) + 32, "a stream is not 32 tokens long")
    near, gaps = stream_divergences(model, reqs, fp_outs, outs, margins,
                                    1e-4)
    same = sum(a.tolist() == b.tolist()
               for (_, kw), a, b in zip(reqs, fp_outs, outs) if not kw)
    seeded = sum(a.tolist() == b.tolist()
                 for (_, kw), a, b in zip(reqs, fp_outs, outs) if kw)
    reg = eng.registry
    slice_line(
        f"gpt2-medium fp32 spec_k={SPEC_K} prompt lookup", eng, wall,
        launches, card,
        f" spec_windows {reg.get('serving.spec_windows').value:.0f}"
        f" spec_proposed {reg.get('serving.spec_proposed').value:.0f}"
        f" spec_accepted {reg.get('serving.spec_accepted').value:.0f}"
        f" spec_acceptance_rate "
        f"{reg.get('serving.spec_acceptance_rate').value:.4f}"
        f" greedy_equal_to_nonspec {same}/10 near_tie_divergences {near} "
        f"at margins {gaps} seeded_equal_to_nonspec {seeded}/2")
    return launches


def depth_ab_phase(card, pairs):
    """``--depth-ab N``: N pairs of phase 4's fp32 serve at async_depth 1
    and 2 on a fresh gpt2-medium from seed 0, the order alternating pair
    by pair (1 2, 2 1, ...), every stream equal to the first serve's.
    Prints each serve's tokens/s and the tracer's tick / dispatch means,
    then per depth the median and quartiles of each, and the pairs each
    depth won on tokens/s."""
    import statistics
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0)
    reqs = traffic(model.embeddings.word_embeddings.weight.shape[0])
    first = None
    runs = {1: [], 2: []}
    wins = {1: 0, 2: 0}
    for i in range(pairs):
        pair = {}
        for depth in ((1, 2) if i % 2 == 0 else (2, 1)):
            eng, outs, wall = serve(model, reqs, Engine, async_depth=depth)
            first = first or outs
            check(all(a.tolist() == b.tolist() for a, b in zip(outs, first)),
                  f"depth A/B pair {i}: a stream differs at depth {depth}")
            r = (eng.tokens_generated / wall, span_ms(eng, ("tick",)),
                 span_ms(eng, ("decode.ragged_stream",)))
            runs[depth].append(r)
            pair[depth] = r[0]
            print(f"depth A/B pair {i} async_depth {depth}: tokens_per_s "
                  f"{r[0]:.2f} tick_ms_mean {r[1]:.4f} dispatch_ms_mean "
                  f"{r[2]:.4f}", flush=True)
            del eng
        wins[max(pair, key=pair.get)] += 1
    for depth, rs in runs.items():
        text = []
        for j, name in enumerate(("tokens_per_s", "tick_ms", "dispatch_ms")):
            q1, med, q3 = statistics.quantiles([r[j] for r in rs], n=4)
            text.append(f"{name} median {med:.4f} quartiles {q1:.4f} "
                        f"{q3:.4f}")
        print(f"depth A/B async_depth {depth} over {len(rs)} serves: "
              + "; ".join(text) + f"; pairs won {wins[depth]} of {pairs} "
              f"[{card}]", flush=True)


def greedy_equal_or_near_tie(model, prompt, a, b, label):
    """Two greedy streams of one prompt: equal, or from a first divergence
    at which the dense forward's top-2 margin is under 1e-4 (phase 4's
    near-tie rule).  Returns the divergence's margin or None."""
    import torch
    a, b = list(a), list(b)
    if a == b:
        return None
    t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    with torch.no_grad():
        ids = torch.tensor([list(prompt) + a[:t]], device="cuda")
        top2 = model(ids)[0, -1].float().topk(2).values
    gap = float(top2[0] - top2[1])
    check(gap < 1e-4, f"{label}: streams diverge at generated token {t} "
          f"where the dense top-2 margin is {gap:.3e}, not a near tie")
    return gap


def preempt_phase(card, model, reqs):
    """Phase 15, priority preemption: on one slot, a priority-0 stream
    of 64 tokens is preempted by a priority-5 request after 16 of them;
    ``serving.preemptions_total`` >= 1, and the resumed stream equals the
    same request served alone (near ties of the dense forward
    excepted)."""
    import torch
    from paddle_tpu_torch.serving import Engine
    kw = dict(num_slots=1, max_seq_len=1024, kv_block_size=16,
              prefill_chunk=64)
    p_low = reqs[1][0]
    p_high = reqs[0][0]
    alone = Engine(model, **kw)
    ref = alone.submit(p_low, max_new_tokens=64)
    alone.run_until_idle()
    eng = Engine(model, **kw)
    low = eng.submit(p_low, max_new_tokens=64, priority=0)
    while len(low.generated) < 16:
        eng.step()
    high = eng.submit(p_high, max_new_tokens=16, priority=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reg = eng.registry
    n = reg.get("serving.preemptions_total").value
    check(n >= 1 and low.preemptions >= 1, "no preemption happened")
    check(len(low.generated) == 64 and len(high.generated) == 16,
          "a preempted or preempting stream is short")
    gap = greedy_equal_or_near_tie(model, p_low, low.generated,
                                   ref.generated, "preemption resume")
    print(f"preemption: preemptions_total {n:.0f} resumed_total "
          f"{reg.get('serving.resumed_total').value:.0f} prefix_hits "
          f"{eng.prefix_hits} low prompt {len(p_low)} tokens, resumed "
          f"stream equal to the uninterrupted one "
          f"{gap is None} (near-tie margin {gap}); wall_s {wall:.3f} "
          f"[{card}]", flush=True)


def mesh_depth_phase(card, ragged_mod, model_fp, reqs, mesh_outs):
    """Phase 15, the mesh under the ring: the (2, 2) mesh serve of phase
    14 (which ran at depth 2) once more at async_depth=1; every stream
    equal."""
    from paddle_tpu_torch.serving import Engine
    tp = model_fp.to_tensor_parallel()
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(tp, reqs, Engine, mesh=one_card_mesh(),
                            async_depth=1)
    n = check_mesh_launches(ragged_mod, eng, "ragged_paged_attention",
                            "mesh depth-1 serve")
    for (_, kw), a, b in zip(reqs, outs, mesh_outs):
        check(a.tolist() == b.tolist(),
              f"mesh: a {'seeded' if kw else 'greedy'} stream differs "
              "between async_depth 1 and 2")
    slice_line(f"gpt2-medium mesh {MESH_SHAPE} fp32", eng, wall, n, card,
               " every stream equal to the depth-2 mesh serve (phase 14)")


# -- phase 16 -------------------------------------------------------------
# the JAX engine's default configuration (attn_impl "xla", contiguous slot
# rows, whole-prompt prefill), and the serves beside it
XLA_DEFAULT = dict(attn_impl="xla", kv_block_size=None, prefill_chunk=None)
XLA_SERVES = (
    ("a", "xla contiguous whole-prompt", XLA_DEFAULT),
    ("b", "xla paged chunks", dict(attn_impl="xla", kv_block_size=16,
                                   prefill_chunk=64)),
    ("c", "ragged after monolithic paged prefill",
     dict(kv_block_size=16, prefill_chunk=None)),
    ("d", f"xla contiguous spec_k={SPEC_K}", dict(XLA_DEFAULT, spec_k=SPEC_K)),
    ("e", "xla contiguous host sampling",
     dict(XLA_DEFAULT, sample_mode="host", async_depth=1)),
)
BUCKET_PROMPTS = (1100, 1500)      # phase 16 (f): gpt3-1.3b, bucket 2048
BF16_TIE = 5e-2                    # a bf16 near tie of the dense forward


def seeded_near_tie(model, prompt, kw, a, b, label):
    """Two seeded streams of one request: equal, or from a first
    divergence at which the draw is shown to sit on a boundary: the
    request's key at that token (``_slot_sample_keys``) puts its uniform
    number, over the dense forward's filtered distribution, within 1e-4
    of the total of the cumulative edge between the two tokens drawn.
    Returns that distance or None."""
    import torch
    from paddle_tpu_torch.models import GPTModel
    a, b = list(a), list(b)
    if a == b:
        return None
    t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    seed = kw["seed"]
    with torch.no_grad():
        ids = torch.tensor([list(prompt) + a[:t]], device="cuda")
        row = model(ids)[0, -1:].float()
        dev = row.device

        def lane(v, dt):
            return torch.tensor([v], dtype=dt, device=dev)

        filt = GPTModel._filter_logits_lanes(
            row, lane(kw["temperature"], torch.float32),
            lane(kw.get("top_k", 0), torch.int32),
            lane(kw.get("top_p", 1.0), torch.float32))
        cum = torch.cumsum(torch.softmax(filt, dim=-1).double(), dim=-1)[0]
        key = GPTModel._slot_sample_keys(
            lane(seed & 0xFFFFFFFF, torch.int64),
            lane(seed >> 32, torch.int64), lane(t, torch.int32))
        target = float(GPTModel._key_uniform(key)[0] * cum[-1])
    edge = float(cum[min(a[t], b[t])])
    gap = abs(target - edge) / float(cum[-1])
    check(gap < 1e-4, f"{label}: seeded streams diverge at generated token "
          f"{t} where the draw sits {gap:.3e} of the total from the "
          "tokens' cumulative edge, not a near tie")
    return gap


def xla_serve(card, ragged_mod, fa, model, reqs, fp_outs, tag, name, kw):
    """One of phase 16's serves of phase 4's traffic, with its checks:
    greedy tokens the dense argmax, greedy and device-mode seeded streams
    equal phase 4's (near ties shown excepted), and the ragged / flash
    launches of its path.  Returns (engine, streams, B1 launches)."""
    from paddle_tpu_torch.serving import Engine
    zero_ragged_counts(ragged_mod)
    zero_flash_counts(fa)
    eng, outs, wall = serve(model, reqs, Engine, **kw)
    label = f"phase 16 ({tag}) {name}"
    counts = ragged_counts(ragged_mod)
    if eng._ragged:
        launches = check_launches(ragged_mod, eng, "ragged_paged_attention",
                                  label)
    else:
        launches = 0
        check(not any(counts.values()),
              f"{label}: ragged kernels launched: {counts}")
    check(not any(flash_counts(fa).values()),
          f"{label}: a flash kernel launched")
    for (p, _), ids in zip(reqs, outs):
        check(len(ids) == len(p) + 32, f"{label}: a stream is short")
    checked, near = teacher_forcing(model, reqs, outs)
    ties, seeded_eq, seeded_ties = [], 0, []
    for (p, rkw), a, b in zip(reqs, outs, fp_outs):
        ga, gb = a[len(p):].tolist(), b[len(p):].tolist()
        if not rkw:
            gap = greedy_equal_or_near_tie(model, p, ga, gb, label)
            if gap is not None:
                ties.append(gap)
        elif eng.sample_mode == "device":
            gap = seeded_near_tie(model, p, rkw, ga, gb, label)
            seeded_eq += gap is None
            if gap is not None:
                seeded_ties.append(gap)
    if eng._paged:
        check(eng.prefix_hits > 0, f"{label}: no prefix-cache hit")
    reg = eng.registry
    slice_line(
        f"gpt2-medium fp32 phase 16 ({tag}) {name}", eng, wall, launches,
        card,
        f" sample_mode {eng.sample_mode} layout "
        f"{'paged' if eng._paged else 'contiguous'} prefill "
        f"{'chunks' if eng._chunk else 'whole'} greedy_checked {checked} "
        f"near_ties {near} greedy_equal_to_phase4 {10 - len(ties)}/10 "
        f"(near-tie divergences at margins {ties})"
        + (f" seeded_equal_to_phase4 {seeded_eq}/2 (near-tie draws "
           f"{seeded_ties})" if eng.sample_mode == "device" else "")
        + f" prefill_chunks {reg.get('serving.prefill_chunks').value:.0f}"
        f" fused_sample_ticks "
        f"{reg.get('serving.fused_sample_ticks').value:.0f}"
        f" d2h_bytes_per_tick "
        f"{reg.get('serving.d2h_bytes_per_tick').value:.0f}")
    return eng, outs, launches


def xla_phase(card, ragged_mod, fa, model, reqs, fp_outs):
    """Phase 16, the XLA and monolithic paths on phase 4's fp32 model and
    traffic, served five ways (``XLA_SERVES``), then the sync-free check
    over (a)'s clean ticks, (e) once more (seeded host streams repeat),
    and a ``profile_phase`` window of (a).  Returns B1's launches in
    (c)."""
    b1 = 0
    for tag, name, kw in XLA_SERVES:
        eng, outs, launches = xla_serve(card, ragged_mod, fa, model, reqs,
                                        fp_outs, tag, name, kw)
        b1 += launches
        if tag == "a":
            a_outs = outs
        if tag == "e":
            from paddle_tpu_torch.serving import Engine
            _, again, _ = serve(model, reqs, Engine, **kw)
            for (_, rkw), x, y in zip(reqs, outs, again):
                check(x.tolist() == y.tolist(),
                      f"phase 16 (e): a {'seeded' if rkw else 'greedy'} "
                      "host-mode stream did not repeat")
            print("phase 16 (e): host-mode streams repeat on a second "
                  "engine", flush=True)
        del eng
    zero_ragged_counts(ragged_mod)
    sync_free_phase(card, model, reqs, a_outs, label=" (phase 16 a)",
                    **XLA_DEFAULT)
    from paddle_tpu_torch.serving import Engine
    profile_phase(model, reqs, Engine, card, label=" xla", **XLA_DEFAULT)
    check(not any(ragged_counts(ragged_mod).values()),
          "phase 16 (a): the XLA path launched a ragged kernel")
    return b1


def bucket_phase(card, ragged_mod, fa):
    """Phase 16 (f): ``gpt3-1.3b`` in bf16 from seed 0 through
    ``Engine(num_slots=2, max_seq_len=2048, attn_impl="xla",
    prefill_buckets="pow2")``; two greedy prompts of ``BUCKET_PROMPTS``
    tokens (numpy seed 1234), 16 new tokens each.  Both pad to the 2048
    bucket, so each prefill runs the flash forward (B5a) once a layer:
    ``flash_fwd`` rises by exactly 24 a prefill, no other flash or ragged
    kernel launches.  Each first token is the dense forward's argmax,
    near ties (margin < 5e-2, bf16) counted.  Returns B5a's launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    model = GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.0
                                 ).to(torch.bfloat16)
    V = model.head.lm_head.weight.shape[0]
    rng = np.random.RandomState(1234)
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in BUCKET_PROMPTS]
    eng = Engine(model, num_slots=2, max_seq_len=2048, attn_impl="xla",
                 prefill_buckets="pow2")
    zero_flash_counts(fa)
    zero_ragged_counts(ragged_mod)
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = flash_counts(fa)
    check(counts["fwd"] == N_LAYERS * len(prompts)
          and counts["bwd_dkv"] == counts["bwd_dq"] == 0,
          f"bucketed prefill: flash launches {counts}, not "
          f"{N_LAYERS} forwards a prefill")
    check(not any(ragged_counts(ragged_mod).values()),
          "bucketed prefill launched a ragged kernel")
    near = 0
    with torch.no_grad():
        for p, r in zip(prompts, reqs):
            ids = r.result(timeout=1)
            check(len(ids) == len(p) + 16, "bucketed prefill: short stream")
            row = model(torch.tensor(p[None].astype("int64"),
                                     device="cuda"))[0, -1].float()
            top2 = row.topk(2).values
            first = int(ids[len(p)])
            if first != int(row.argmax()):
                check(float(top2[0] - top2[1]) < BF16_TIE,
                      f"bucketed prefill: first token of a {len(p)}-token "
                      "prompt is not the dense argmax")
                near += 1
    prefill_ms = [e["dur"] / 1e3 for e in eng.chrome_trace()["traceEvents"]
                  if e.get("ph") == "X" and e["name"] == "prefill"]
    print(f"phase 16 (f) gpt3-1.3b bf16 bucketed prefill: prompts "
          f"{list(BUCKET_PROMPTS)} -> bucket 2048, flash_fwd launches "
          f"{counts['fwd']} ({N_LAYERS} a prefill), first tokens the dense "
          f"argmax {len(prompts) - near}/{len(prompts)} (near ties {near}), "
          f"prefill_ms " + " ".join(f"{m:.3f}" for m in prefill_ms)
          + f" wall_s {wall:.3f} generated_tokens {eng.tokens_generated} "
          f"[{card}]", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return counts["fwd"]


# -- phase 17 -------------------------------------------------------------
GEN_B, GEN_PROMPT, GEN_NEW = 2, 256, 64
GEN_MODES = (False, True, "fused", "speculative")
GEN_SEEDED = dict(top_k=50, temperature=0.9, seed=5)
LORA_NAMES = (None, "a", "b")      # request i serves LORA_NAMES[i % 3]
OFFLOAD_WAVES = ((257, 321, 193, 385), (300, 280, 350, 240))
OFFLOAD_KW = dict(num_slots=4, kv_blocks=96, kv_host_mb=2048)


def generate_phase(card, model):
    """Phase 17 (a): ``GPTModel.generate`` of two 256-token prompts (numpy
    seed 4321), 64 new tokens, in the four modes.  Every greedy token is
    the dense forward's argmax (phase 4's near-tie rule); each mode's rows
    equal the eager rows except from a first divergence at a dense near
    tie; a seeded ``"fused"`` run repeats.  Prints each mode's wall time,
    tokens/s and ``last_spec_forwards``."""
    import numpy as np
    import torch
    V = model.embeddings.word_embeddings.weight.shape[0]
    ids = np.random.RandomState(4321).randint(0, V, (GEN_B, GEN_PROMPT))
    reqs = [(ids[b].astype(np.int32), {}) for b in range(GEN_B)]
    outs = {}
    for mode in GEN_MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=GEN_NEW, compiled=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outs[mode] = out.cpu().numpy()
        check(outs[mode].shape == (GEN_B, GEN_PROMPT + GEN_NEW),
              f"generate({mode!r}): shape {outs[mode].shape}")
        checked, near = teacher_forcing(model, reqs, list(outs[mode]))
        ties = [greedy_equal_or_near_tie(
                    model, p, outs[mode][b, GEN_PROMPT:],
                    outs[False][b, GEN_PROMPT:], f"generate({mode!r})")
                for b, (p, _) in enumerate(reqs)]
        fwd = (f" last_spec_forwards {model.last_spec_forwards}"
               if mode == "speculative" else "")
        print(f"phase 17 (a) generate compiled={mode!r}: B {GEN_B} prompt "
              f"{GEN_PROMPT} new {GEN_NEW} wall_s {wall:.3f} tokens_per_s "
              f"{GEN_B * GEN_NEW / wall:.2f} greedy_checked {checked} "
              f"near_ties {near} rows_equal_to_eager "
              f"{sum(t is None for t in ties)}/{GEN_B}{fwd} [{card}]",
              flush=True)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(model.generate(ids, max_new_tokens=GEN_NEW,
                                   compiled="fused", **GEN_SEEDED).cpu())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(torch.equal(runs[0], runs[1]),
          "generate(compiled='fused') seeded run did not repeat")
    print(f"phase 17 (a) generate fused seeded {GEN_SEEDED}: repeats; "
          f"wall_s {wall:.3f} tokens_per_s {GEN_B * GEN_NEW / wall:.2f}",
          flush=True)


def copy_of(model, adapter=None):
    """A second gpt2-medium with ``model``'s weights (``adapter`` merged
    into its out_proj weights when given)."""
    from paddle_tpu_torch.models import GPTModel
    m = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0)
    m.load_state_dict(model.state_dict())
    if adapter is not None:
        adapter.merge_into(m)
    return m.eval()


def check_against(model, reqs, outs, refs, label):
    """Streams against reference streams of the same requests: greedy
    ones equal except from a first divergence at a dense near tie,
    seeded ones except at a draw shown to sit on a cumulative edge
    (``seeded_near_tie``).  ``model`` is one model or one per request.
    Returns (greedy equal, greedy total, seeded equal, seeded total)."""
    g_eq = g_n = s_eq = s_n = 0
    for i, ((p, kw), a, b) in enumerate(zip(reqs, outs, refs)):
        m = model[i] if isinstance(model, (list, tuple)) else model
        ga, gb = a[len(p):].tolist(), b[len(p):].tolist()
        kw = {k: v for k, v in kw.items() if k != "adapter"}
        if kw:
            s_n += 1
            s_eq += seeded_near_tie(m, p, kw, ga, gb, label) is None
        else:
            g_n += 1
            g_eq += greedy_equal_or_near_tie(m, p, ga, gb, label) is None
    return g_eq, g_n, s_eq, s_n


class RecordingProposer:
    """Wraps a proposer and logs every (history, draft)."""

    def __init__(self, inner):
        self.inner = inner
        self.vocab_size = inner.vocab_size
        self.log = []

    def propose(self, history, k):
        import numpy as np
        d = np.asarray(self.inner.propose(history, k))
        self.log.append((np.asarray(history).copy(), d.copy()))
        return d


def draft_agreement(model, reqs, outs, log):
    """Greedy requests' draft lanes against their served streams: a draft
    token must be the stream's token at its position, or sit at a dense
    near tie (margin < 1e-4; the rest of that draft, conditioned on
    another prefix, is not counted).  Returns (lanes, equal, near
    ties)."""
    import numpy as np
    import torch
    lanes = equal = ties = 0
    greedy = [(p, ids) for (p, kw), ids in zip(reqs, outs) if not kw]
    for history, d in log:
        ids = next((ids for p, ids in greedy
                    if np.array_equal(history[:len(p)], p)), None)
        if ids is None:
            continue
        pos = len(history)
        for j, tok in enumerate(d.tolist()):
            lanes += 1
            if int(ids[pos + j]) == tok:
                equal += 1
                continue
            with torch.no_grad():
                row = model(torch.tensor([ids[:pos + j].tolist()],
                                         device="cuda"))[0, -1].float()
            top2 = row.topk(2).values
            gap = float(top2[0] - top2[1])
            check(gap < 1e-4, f"draft token {tok} at position {pos + j} is "
                  f"not the stream's {int(ids[pos + j])} and the dense "
                  f"top-2 margin is {gap:.3e}, not a near tie")
            ties += 1
            break
    return lanes, equal, ties


def spec_line(eng):
    reg = eng.registry
    return (f" spec_windows {reg.get('serving.spec_windows').value:.0f}"
            f" spec_proposed {reg.get('serving.spec_proposed').value:.0f}"
            f" spec_accepted {reg.get('serving.spec_accepted').value:.0f}"
            f" spec_acceptance_rate "
            f"{reg.get('serving.spec_acceptance_rate').value:.4f}")


def draft_phase(card, ragged_mod, model, reqs, fp_outs):
    """Phase 17 (b): ``Engine(spec_k=3)`` drafting with
    ``DraftModelProposer`` over an fp32 copy of the target, phase 4's
    traffic: every greedy draft lane equals the served stream (dense near
    ties excepted: acceptance 1.0 on greedy lanes), streams equal phase
    4's (near ties excepted), B1 launched 24 times a dispatch.  Then the
    copy at ``weight_dtype="int8"`` on the first 6 requests: streams
    equal phase 4's, acceptance printed.  Drafting reads each draft back
    to the host, so phase 15's sync-free check does not apply to these
    serves.  Returns B1's launches."""
    from paddle_tpu_torch.serving import DraftModelProposer, Engine
    rec = RecordingProposer(DraftModelProposer(copy_of(model)))
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(model, reqs, Engine, spec_k=SPEC_K, proposer=rec)
    launches = check_launches(ragged_mod, eng, "ragged_paged_attention",
                              "draft-model serve")
    for (p, _), ids in zip(reqs, outs):
        check(len(ids) == len(p) + 32, "draft serve: a stream is short")
    lanes, equal, ties = draft_agreement(model, reqs, outs, rec.log)
    check(lanes > 0, "draft serve: no greedy draft lane")
    g_eq, g_n, s_eq, s_n = check_against(model, reqs, outs, fp_outs,
                                         "draft serve")
    slice_line(
        f"gpt2-medium fp32 phase 17 (b) spec_k={SPEC_K} draft model fp32",
        eng, wall, launches, card,
        spec_line(eng) + f" greedy_draft_lanes {lanes} equal {equal} "
        f"near_ties {ties} greedy_lane_acceptance {equal / lanes:.4f} "
        f"greedy_equal_to_phase4 {g_eq}/{g_n} seeded_equal_to_phase4 "
        f"{s_eq}/{s_n}")
    del rec, eng
    head = reqs[:6]
    zero_ragged_counts(ragged_mod)
    eng, outs8, wall = serve(
        model, head, Engine, spec_k=SPEC_K,
        proposer=DraftModelProposer(copy_of(model), weight_dtype="int8"))
    n8 = check_launches(ragged_mod, eng, "ragged_paged_attention",
                        "int8 draft-model serve")
    g_eq, g_n, s_eq, s_n = check_against(model, head, outs8, fp_outs[:6],
                                         "int8 draft serve")
    slice_line(
        f"gpt2-medium fp32 phase 17 (b) spec_k={SPEC_K} draft model "
        "weight-only int8, first 6 requests", eng, wall, n8, card,
        spec_line(eng) + f" greedy_equal_to_phase4 {g_eq}/{g_n} "
        f"seeded_equal_to_phase4 {s_eq}/{s_n}")
    return launches + n8


def lora_phase(card, ragged_mod, model, reqs, fp_outs):
    """Phase 17 (c): ``Engine(adapters={"a": rank 8, "b": rank 16},
    max_adapters=4)``, phase 4's traffic spread over base, "a" and "b"
    (``LORA_NAMES``).  Adapter streams teacher-forced against the dense
    forward of a ``merge_into`` copy, base streams equal phase 4's (near
    ties excepted); mid-serve a third adapter is loaded and serves one
    more request (teacher-forced against its merged copy), and unloading
    "a" while its requests pin it is refused; B1 launched 24 times a
    dispatch.  The same 12 requests at ``attn_impl="xla"``: streams equal
    the ragged run's.  A ``profile_phase`` window (kernels a tick).
    Returns B1's launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import AdapterInUse, Engine, LoRAAdapter
    E, n_layers = model.blocks[0].attn.hidden_size, len(model.blocks)
    adapters = {"a": LoRAAdapter.random(8, E, n_layers, seed=1),
                "b": LoRAAdapter.random(16, E, n_layers, seed=2)}
    third = LoRAAdapter.random(4, E, n_layers, seed=3)
    lreqs = [(p, dict(kw, adapter=LORA_NAMES[i % 3]) if LORA_NAMES[i % 3]
              else kw) for i, (p, kw) in enumerate(reqs)]
    merged = {n: copy_of(model, ad) for n, ad in adapters.items()}
    merged["c"] = copy_of(model, third)
    per_req = [merged[kw["adapter"]] if "adapter" in kw else model
               for _, kw in lreqs]
    zero_ragged_counts(ragged_mod)
    eng, handles = submit_all(model, lreqs, Engine, adapters=adapters,
                              max_adapters=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        eng.step()
    check(eng.adapters.pins("a") > 0, "lora serve: adapter a not pinned")
    eng.load_adapter("c", third)
    try:
        eng.unload_adapter("a")
        refused = False
    except AdapterInUse:
        refused = True
    check(refused, "lora serve: unloading a pinned adapter was not refused")
    V = model.embeddings.word_embeddings.weight.shape[0]
    extra = np.random.RandomState(77).randint(0, V, 120).astype(np.int32)
    handles.append(eng.submit(extra, max_new_tokens=32, adapter="c"))
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [h.result(timeout=1) for h in handles]
    launches = check_launches(ragged_mod, eng, "ragged_paged_attention",
                              "lora serve")
    checked = near = 0
    for (p, kw), ids, m in zip(lreqs + [(extra, {"adapter": "c"})], outs,
                               per_req + [merged["c"]]):
        check(len(ids) == len(p) + 32, "lora serve: a stream is short")
        if set(kw) <= {"adapter"}:
            c, n = teacher_forcing(m, [(p, {})], [ids])
            checked += c
            near += n
    base = [i for i, (_, kw) in enumerate(lreqs) if "adapter" not in kw]
    g_eq, g_n, s_eq, s_n = check_against(
        model, [reqs[i] for i in base], [outs[i] for i in base],
        [fp_outs[i] for i in base], "lora serve base lanes")
    differs = sum(outs[i].tolist() != fp_outs[i].tolist()
                  for i, (_, kw) in enumerate(lreqs) if "adapter" in kw)
    slice_line(
        "gpt2-medium fp32 phase 17 (c) lora a:r8 b:r16 (+ c:r4 loaded "
        "mid-serve)", eng, wall, launches, card,
        f" greedy_checked {checked} near_ties {near} "
        f"base_greedy_equal_to_phase4 {g_eq}/{g_n} "
        f"base_seeded_equal_to_phase4 {s_eq}/{s_n} "
        f"adapter_streams_differing_from_base {differs}/{12 - len(base)} "
        f"unload_while_pinned refused")
    zero_ragged_counts(ragged_mod)
    xeng, xouts, xwall = serve(model, lreqs, Engine, adapters=adapters,
                               max_adapters=4, **XLA_DEFAULT)
    check(not any(ragged_counts(ragged_mod).values()),
          "lora xla serve launched a ragged kernel")
    g_eq, g_n, s_eq, s_n = check_against(per_req, lreqs, xouts, outs[:12],
                                         "lora xla serve")
    slice_line("gpt2-medium fp32 phase 17 (c) lora at attn_impl=xla", xeng,
               xwall, 0, card,
               f" greedy_equal_to_ragged {g_eq}/{g_n} seeded_equal_to_ragged "
               f"{s_eq}/{s_n}")
    del merged, per_req, xeng, eng
    profile_phase(model, lreqs, Engine, card, label=" lora",
                  adapters=adapters, max_adapters=4)
    return launches


def offload_serve(card, ragged_mod, model, label, kernel, **kw):
    """Phase 17 (d), one pool form: a 96-block pool, a 2048 MiB host tier,
    three waves (``OFFLOAD_WAVES``: the first wave's prompts cached, the
    second's evicting them, the first wave again restored from host RAM).
    Restored streams equal a ``prefix_cache=False`` engine's except where
    its own top-2 margin is under ``margin`` (fp32 1e-4, int8 1e-3: phase
    10's rule); demotes, promotes and restored tokens all > 0; the path's
    kernel launched 24 times a dispatch.  Returns its launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import Engine
    V = model.embeddings.word_embeddings.weight.shape[0]
    rng = np.random.RandomState(2024)
    waves = [[(rng.randint(0, V, n).astype(np.int32), {}) for n in lens]
             for lens in OFFLOAD_WAVES]
    waves.append(waves[0])
    zero_ragged_counts(ragged_mod)
    eng = Engine(model, max_seq_len=1024, kv_block_size=16, prefill_chunk=64,
                 **OFFLOAD_KW, **kw)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves:
        handles = [eng.submit(p, max_new_tokens=32) for p, _ in wave]
        eng.run_until_idle()
        outs.append([h.result(timeout=1) for h in handles])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_launches(ragged_mod, eng, kernel, f"offload {label}")
    reg = eng.registry
    demotes = reg.get("serving.offload_demotes").value
    promotes = reg.get("serving.offload_promotes").value
    hit = reg.get("serving.offload_hit_tokens").value
    check(demotes > 0 and promotes > 0 and hit > 0,
          f"offload {label}: demotes {demotes} promotes {promotes} "
          f"hit tokens {hit}")
    margin = 1e-3 if "kv_dtype" in kw else 1e-4
    _, ref, _, margins = serve_recording_margins(
        model, waves[0], prefix_cache=False, num_slots=4, **kw)
    near, gaps = stream_divergences(model, waves[0], outs[2], ref, margins,
                                    margin)
    exact = sum(a.tolist() == b.tolist() for a, b in zip(outs[2], ref))
    same_as_first = sum(a.tolist() == b.tolist()
                        for a, b in zip(outs[2], outs[0]))
    slice_line(
        f"gpt2-medium fp32 phase 17 (d) offload {label}", eng, wall,
        launches, card,
        f" offload_demotes {demotes:.0f} offload_promotes {promotes:.0f} "
        f"offload_hit_tokens {hit:.0f} kv_host_blocks "
        f"{reg.get('serving.kv_host_blocks').value:.0f} kv_host_bytes "
        f"{reg.get('serving.kv_host_bytes').value:.0f} "
        f"restored_equal_to_no_cache {exact}/4 (near-tie divergences "
        f"{near} at margins {gaps}) restored_equal_to_first_wave "
        f"{same_as_first}/4")
    return launches


def stream_phase(card, model, reqs, fp_outs):
    """Phase 17 (e): a ``TokenStream`` attached to phase 4's first request
    yields exactly its buffered tokens, which equal phase 4's."""
    from paddle_tpu_torch.serving import Engine, TokenStream
    eng, handles = submit_all(model, reqs[:1], Engine)
    stream = TokenStream(handles[0])
    eng.run_until_idle()
    got = stream.drain(timeout=10)
    want = [int(t) for t in handles[0].generated]
    check(got == want, "the streamed tokens differ from the buffered ones")
    p = reqs[0][0]
    g_eq, _, _, _ = check_against(model, reqs[:1], [handles[0].result(1)],
                                  fp_outs[:1], "stream")
    print(f"phase 17 (e) stream: {len(got)} tokens streamed, equal to the "
          f"buffered result; prompt {len(p)} tokens, greedy_equal_to_phase4 "
          f"{g_eq}/1", flush=True)


def serving_features_phase(card, ragged_mod, model, reqs, fp_outs):
    """Phase 17: generate, the draft-model spec serve, LoRA, offload and
    streaming on phase 4's fp32 model.  Returns (B1 launches, B2
    launches) of its main-path serves."""
    generate_phase(card, model)
    b1 = draft_phase(card, ragged_mod, model, reqs, fp_outs)
    b1 += lora_phase(card, ragged_mod, model, reqs, fp_outs)
    b1 += offload_serve(card, ragged_mod, model, "fp32",
                        "ragged_paged_attention")
    b2 = offload_serve(card, ragged_mod, model, "int8 KV",
                       "ragged_paged_attention_int8", kv_dtype="int8")
    stream_phase(card, model, reqs, fp_outs)
    return b1, b2


# -- phase 18 -------------------------------------------------------------
# the short chaos storm of tests/test_faults.py: its sites and rates; the
# watchdog and the hang sized for a gpt2-medium tick (tens of ms)
STORM_RATES = {"dispatch": 0.04, "d2h_hang": 0.03, "pool_exhaust": 0.03,
               "host_slow": 0.05, "spec_draft": 0.08}
STORM_KW = dict(hang_s=30.0, slow_s=0.002)
STORM_WATCHDOG_S = 3.0
STORM_TICKS = (5, 60)              # the storm's window, after the start
STORM_EVERY = 6                    # request i is submitted at tick 6 * i
MIGRATE_AFTER = 8                  # tokens a stream emits before it moves
FLEET_DIR = os.path.join(HERE, "build", "phase18_fleet")
INJECTED = ("InjectedFault", "NoFreeBlocks", "WatchdogTimeout")


def migrate_pair(model, reqs, ref_outs, recording=False, **engine_kw):
    """Phase 18 (a), one pool form: every request of the traffic served
    on engine A, exported once it has ``MIGRATE_AFTER`` tokens (the
    demands registered at submit, ``deliver="return"``), imported by
    engine B, every other payload through its JSON wire form, and decoded
    to the end there.  Returns (A, B, payloads, streams, wall, margins of
    B when ``recording``)."""
    import torch
    from paddle_tpu_torch.serving import Engine, payload_to_json
    from paddle_tpu_torch.serving.engine import Migrated
    ekw = dict(num_slots=8, max_seq_len=1024, kv_block_size=16,
               prefill_chunk=64)
    ekw.update(engine_kw)
    a = Engine(model, **ekw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles, demands = [], []
    for p, kw in reqs:
        h = a.submit(p, max_new_tokens=32, **kw)
        handles.append(h)
        demands.append(a.migrate_out(request_id=h.id,
                                     min_tokens=MIGRATE_AFTER,
                                     deliver="return", wait=False))
    for _ in range(2000):
        if all(d.done.is_set() for d in demands):
            break
        a.step()
    verdicts = [d.wait(0) for d in demands]
    for v, h in zip(verdicts, handles):
        check(v["completed"] is False and v["payload"] is not None,
              "phase 18 (a): a stream finished before its export")
        check(isinstance(h.error, Migrated)
              and h.error.emitted == v["generated"],
              "phase 18 (a): the exported waiter did not end in Migrated")
    payloads = [v["payload"] for v in verdicts]
    margins, undo = {}, None
    cls = Engine
    if recording:
        cls, margins, undo = recording_engine()
    try:
        b = cls(model, **ekw)
        ins = [b.migrate_in(payload_to_json(pl) if i % 2 else pl,
                            wait=False)
               for i, pl in enumerate(payloads)]
        b.run_until_idle()
    finally:
        if undo is not None:
            undo()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = [d.wait(0) for d in ins]
    outs = [g["request"].result(timeout=1) for g in got]
    for g, pl in zip(got, payloads):
        check(g["blocks"] == pl["kv"]["n_blocks"] >= 1,
              "phase 18 (a): the import did not adopt every block")
    b.prefix_cache.clear()
    check(b.block_pool.in_use() == 0,
          "phase 18 (a): blocks leaked on the importing engine")
    return a, b, payloads, outs, wall, margins


def check_no_leak(eng, label):
    """Once its trie lets go, an idle engine's pool is at refcount 0."""
    eng.prefix_cache.clear()
    check(eng.block_pool.in_use() == 0, f"{label}: KV blocks leaked")


def migration_costs(b, payloads, card):
    """Per-block costs of the wire, on engine B's pools: the export's
    gather + download and the import's upload + write (wall clock around
    a synchronize), the payload's bytes a block, and the JSON encode
    (``payload_to_json`` + ``json.dumps``) and decode of the longest
    stream's payload.  Also the engines' own ``migrate.export`` span
    means (gather + download, a block)."""
    import torch
    from paddle_tpu_torch.serving import (export_blocks, import_blocks,
                                          payload_from_json,
                                          payload_to_json)
    longest = max(payloads, key=lambda pl: pl["kv"]["n_blocks"])
    n = longest["kv"]["n_blocks"]
    data = longest["kv"]["data"]
    blocks = b.block_pool.alloc(n)
    try:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            import_blocks(b.k_pools, b.v_pools, blocks, data)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            back = export_blocks(b.k_pools, b.v_pools, blocks)
            t2 = time.perf_counter()
            times.append((t1 - t0, t2 - t1))
        check(back.tobytes() == data.tobytes(),
              "phase 18 (a): export after import is not bitwise the payload")
    finally:
        b.block_pool.decref(blocks)
    imp = min(t[0] for t in times) * 1e3 / n
    exp = min(t[1] for t in times) * 1e3 / n
    t0 = time.perf_counter()
    text = json.dumps(payload_to_json(longest))
    t1 = time.perf_counter()
    back = payload_from_json(json.loads(text))
    t2 = time.perf_counter()
    check(back["kv"]["data"].tobytes() == data.tobytes(),
          "phase 18 (a): the JSON wire form does not round-trip")
    print(f"phase 18 (a) wire: bytes_per_block {data.nbytes // n} "
          f"export_gather_download_ms_per_block {exp:.4f} "
          f"import_ms_per_block {imp:.4f} (over {n} blocks, best of 3) "
          f"longest_payload_blocks {n} json_bytes {len(text)} "
          f"json_encode_ms {(t1 - t0) * 1e3:.1f} json_decode_ms "
          f"{(t2 - t1) * 1e3:.1f} [{card}]", flush=True)


def migration_phase(card, ragged_mod, model, reqs, fp_outs, model_q,
                    q_outs):
    """Phase 18 (a).  Returns (B1 launches, B2 launches)."""
    from paddle_tpu_torch.serving import Engine, KVDtypeMismatch
    zero_ragged_counts(ragged_mod)
    a, b, payloads, outs, wall, _ = migrate_pair(model, reqs, fp_outs)
    b1 = ragged_counts(ragged_mod)["ragged_paged_attention"]
    check(b1 == (a.ragged_dispatches + b.ragged_dispatches) * N_LAYERS,
          f"phase 18 (a): B1 launched {b1} times, not (A {a.ragged_dispatches}"
          f" + B {b.ragged_dispatches}) dispatches x {N_LAYERS}")
    g_eq, g_n, s_eq, s_n = check_against(model, reqs, outs, fp_outs,
                                         "phase 18 (a) migration")
    blocks = sum(pl["kv"]["n_blocks"] for pl in payloads)
    check(a.registry.get("serving.kv_blocks_migrated").value == blocks,
          "phase 18 (a): serving.kv_blocks_migrated != blocks exported")
    print(f"phase 18 (a) migration fp32: 12 streams A -> B after "
          f"{MIGRATE_AFTER} tokens (6 live, 6 JSON wire), blocks {blocks}, "
          f"greedy_equal_to_phase4 {g_eq}/{g_n} seeded_equal {s_eq}/{s_n}, "
          f"B1 launches {b1} (A {a.ragged_dispatches} + B "
          f"{b.ragged_dispatches} dispatches) wall_s {wall:.3f} "
          f"export_span_ms_mean {span_ms(a, ('migrate.export',)):.4f} "
          f"import_span_ms_mean {span_ms(b, ('migrate.import',)):.4f} "
          f"[{card}]", flush=True)
    migration_costs(b, payloads, card)
    # prefix warming: A's trie keeps the exported prompts' blocks
    sys_req = reqs[5]
    c = Engine(model, num_slots=8, max_seq_len=1024, kv_block_size=16,
               prefill_chunk=64)
    d = a.export_prefix(sys_req[0], wait=False)
    a.step()
    payload = d.wait(0)
    check(payload is not None, "phase 18 (a): export_prefix found nothing")
    d = c.import_prefix(payload, wait=False)
    c.step()
    warmed = d.wait(0)
    h = c.submit(sys_req[0], max_new_tokens=32, **sys_req[1])
    c.run_until_idle()
    check(c.prefix_hits >= 1
          and c.prefix_hit_tokens >= warmed["tokens"] > 0,
          f"phase 18 (a): the warmed engine's prefix hits did not rise "
          f"({c.prefix_hits}, {c.prefix_hit_tokens} tokens)")
    check_against(model, [sys_req], [h.result(timeout=1)], [fp_outs[5]],
                  "phase 18 (a) prefix warming")
    dispatches = (a.ragged_dispatches + b.ragged_dispatches
                  + c.ragged_dispatches)
    b1 = ragged_counts(ragged_mod)["ragged_paged_attention"]
    check(b1 == dispatches * N_LAYERS,
          f"phase 18 (a): B1 launched {b1} times over the migration pair "
          f"and the warmed engine, not {dispatches} dispatches x "
          f"{N_LAYERS}")
    print(f"phase 18 (a) prefix warming: {warmed['blocks']} blocks "
          f"({payload['tier']}) into a fresh engine, its prefix hits "
          f"{c.prefix_hits} ({c.prefix_hit_tokens} tokens), stream equal "
          f"to phase 4's", flush=True)
    check_no_leak(a, "phase 18 (a) exporting engine")
    check_no_leak(c, "phase 18 (a) warmed engine")
    # fp32 blocks into int8 pools adopt nothing
    cq = Engine(model_q, num_slots=8, max_seq_len=1024, kv_block_size=16,
                prefill_chunk=64, kv_dtype="int8")
    d = cq.migrate_in(payloads[0], wait=False)
    cq.step()
    try:
        d.wait(0)
        check(False, "phase 18 (a): fp32 blocks imported into int8 pools")
    except KVDtypeMismatch:
        pass
    check(cq.block_pool.in_use() == 0 and cq.queue.depth() == 0,
          "phase 18 (a): a refused import left state behind")
    del a, b, c, cq
    # the int8-KV pair on phase 10's relayouted model
    zero_ragged_counts(ragged_mod)
    a, b, payloads, outs, wall, margins = migrate_pair(
        model_q, reqs, q_outs, recording=True, kv_dtype="int8")
    counts = ragged_counts(ragged_mod)
    b2 = counts["ragged_paged_attention_int8"]
    check(b2 == (a.ragged_dispatches + b.ragged_dispatches) * N_LAYERS
          and sum(counts.values()) == b2,
          f"phase 18 (a) int8: ragged launches {counts} for "
          f"{a.ragged_dispatches} + {b.ragged_dispatches} dispatches")
    check(all(pl["kv"]["dtype"] == "int8" and "scales" in pl["kv"]
              for pl in payloads), "phase 18 (a): int8 payloads lack scales")
    check_no_leak(a, "phase 18 (a) int8 exporting engine")
    near, gaps = stream_divergences(model_q, reqs, q_outs, outs, margins,
                                    1e-3)
    same = sum(x.tolist() == y.tolist()
               for (_, kw), x, y in zip(reqs, q_outs, outs) if not kw)
    print(f"phase 18 (a) migration int8 KV: greedy streams equal to phase "
          f"10's {same} of 10, near-tie divergences (int8 margin < 1e-3) "
          f"{near} at margins {gaps}; B2 launches {b2} wall_s {wall:.3f} "
          f"[{card}]", flush=True)
    return b1, b2


def post_json(url, obj, timeout=600.0):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def post_all(url, reqs):
    """Every request as a concurrent ``POST /generate``; returns (ids as
    arrays, wall)."""
    import threading
    import numpy as np
    outs = [None] * len(reqs)
    errs = []

    def call(k):
        p, kw = reqs[k]
        try:
            outs[k] = np.asarray(post_json(url + "/generate", dict(
                {"prompt": [int(t) for t in p], "max_new_tokens": 32},
                **kw))["ids"])
        except Exception as e:  # reported below, then the phase fails
            errs.append(repr(e))

    threads = [threading.Thread(target=call, args=(k,), daemon=True)
               for k in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not errs and all(o is not None for o in outs),
          f"requests failed: {errs}")
    return outs, wall


@contextlib.contextmanager
def timed_calls(targets):
    """Wrap each ``(owner, attribute, label)`` callable so that every
    call appends its wall time (ms, host clock) to ``times[label]``;
    yields ``times`` and puts the originals back on exit."""
    times = {label: [] for _, _, label in targets}
    saved = []

    def timed(fn, label):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                times[label].append((time.perf_counter() - t0) * 1e3)
        return call

    for owner, attr, label in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed(fn, label))
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def span_list_ms(eng, name):
    """Durations (ms, host clock) of the engine tracer's spans of this
    name."""
    return [e["dur"] / 1e3 for e in eng.chrome_trace()["traceEvents"]
            if e.get("ph") == "X" and e["name"] == name]


def breakdown_text(parts):
    """``label n= sum_s= mean_ms=`` for each measured part."""
    return "; ".join(
        f"{label} n={len(ms)} sum_s={sum(ms) / 1e3:.3f} "
        f"mean_ms={sum(ms) / len(ms) if ms else 0.0:.2f}"
        for label, ms in parts)


def front_end_phase(card, ragged_mod, model, reqs, fp_outs, phase4_tps):
    """Phase 18 (b).  Returns B1 launches (counted, in the engines'
    threads).  The routed serve's wall is broken down by measurement:
    the router's two calls a request, the handlers' JSON work and the
    engines' migration spans, all in this process."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving import (Engine, EngineServer,
                                          HttpReplicaClient, Router,
                                          RouterPolicy, RouterServer)
    from paddle_tpu_torch.serving import httpd as httpd_mod
    ekw = dict(num_slots=8, max_seq_len=1024, kv_block_size=16,
               prefill_chunk=64)
    zero_ragged_counts(ragged_mod)
    with EngineServer(Engine(model, **ekw)) as srv:
        outs, wall = post_all(srv.address, reqs)
        g_eq, g_n, s_eq, s_n = check_against(model, reqs, outs, fp_outs,
                                             "phase 18 (b) httpd")
        eng = srv.engine
    print(f"phase 18 (b) EngineServer: 12 concurrent POST /generate, "
          f"greedy_equal_to_phase4 {g_eq}/{g_n} seeded_equal {s_eq}/{s_n} "
          f"tokens_per_s {12 * 32 / wall:.2f} wall_s {wall:.3f} [{card}]",
          flush=True)
    dispatches = eng.ragged_dispatches
    with EngineServer(Engine(model, **ekw), role="prefill") as pre, \
            EngineServer(Engine(model, **ekw), role="decode") as dec:
        router = Router({"prefill": HttpReplicaClient(pre.address,
                                                      timeout_s=600),
                         "decode": HttpReplicaClient(dec.address,
                                                     timeout_s=600)},
                        policy=RouterPolicy(disaggregate=True, seed=0),
                        kv_block_size=16, registry=monitor.StatRegistry())
        targets = [
            (HttpReplicaClient, "migrate_export",
             "router POST /migrate/export (submit to payload received)"),
            (HttpReplicaClient, "migrate_import",
             "router POST /migrate/import (payload sent to last token)"),
            (httpd_mod, "payload_to_json", "handler base64 encode"),
            (httpd_mod._Handler, "_send_json",
             "handler json.dumps + write"),
            (httpd_mod._Handler, "_read_body", "handler read + json.loads")]
        with RouterServer(router) as rs, timed_calls(targets) as times:
            router.probe_once()
            outs, wall = post_all(rs.address, reqs)
        migrations = router.registry.get("router.migrations_total").value
        dispatches += (pre.engine.ragged_dispatches
                       + dec.engine.ragged_dispatches)
        parts = [(label, times[label]) for _, _, label in targets] + [
            ("prefill engine migrate.export",
             span_list_ms(pre.engine, "migrate.export")),
            ("decode engine migrate.wire (base64 decode)",
             span_list_ms(dec.engine, "migrate.wire")),
            ("decode engine migrate.import",
             span_list_ms(dec.engine, "migrate.import")),
            ("prefill engine tick", span_list_ms(pre.engine, "tick")),
            ("decode engine tick", span_list_ms(dec.engine, "tick"))]
    g_eq, g_n, s_eq, s_n = check_against(model, reqs, outs, fp_outs,
                                         "phase 18 (b) routed")
    check(migrations == len(reqs),
          f"phase 18 (b): router_migrations_total {migrations} != "
          f"{len(reqs)}")
    b1 = ragged_counts(ragged_mod)["ragged_paged_attention"]
    check(b1 == dispatches * N_LAYERS,
          f"phase 18 (b): B1 launched {b1} times, not {dispatches} "
          f"dispatches x {N_LAYERS}")
    print(f"phase 18 (b) routed (disaggregated prefill -> decode over "
          f"routerd): greedy_equal_to_phase4 {g_eq}/{g_n} seeded_equal "
          f"{s_eq}/{s_n} router_migrations_total {migrations:.0f} "
          f"tokens_per_s {12 * 32 / wall:.2f} (phase 4 "
          f"{phase4_tps:.2f}) wall_s {wall:.3f} B1 launches {b1} "
          f"[{card}]", flush=True)
    print(f"phase 18 (b) routed breakdown (host clock, 12 concurrent "
          f"requests, so parts overlap): {breakdown_text(parts)} "
          f"[{card}]", flush=True)
    return b1


def storm_run(model, reqs, seed):
    """One seeded storm (``STORM_RATES``) over a ragged engine at
    ``spec_k=2`` with a watchdog: phase 4's request i submitted before
    tick ``STORM_EVERY * i`` (the last ones after the window), every tick
    stepped, errors absorbed as the background loop absorbs them.
    Returns (engine, handles, fault log, errors)."""
    from paddle_tpu_torch.serving import Engine, FaultInjector
    inj = FaultInjector(seed=seed, rates=STORM_RATES,
                        first_tick=STORM_TICKS[0],
                        last_tick=STORM_TICKS[1], **STORM_KW)
    eng = Engine(model, num_slots=8, max_seq_len=1024, kv_block_size=16,
                 prefill_chunk=64, spec_k=2, faults=inj,
                 watchdog_s=STORM_WATCHDOG_S)
    handles, errors = [], []
    for t in range(3000):
        if t % STORM_EVERY == 0 and len(handles) < len(reqs):
            p, kw = reqs[len(handles)]
            handles.append(eng.submit(p, max_new_tokens=32, **kw))
        elif eng.scheduler.idle() and len(handles) == len(reqs):
            break
        try:
            eng.step()
        except Exception as e:  # step() already recovered the engine
            errors.append(type(e).__name__)
    check(eng.scheduler.idle() and not eng._ring,
          "phase 18 (c): the engine did not drain after the storm")
    eng.stop()
    return eng, handles, list(inj.log), errors


def fault_phase(card, ragged_mod, model, reqs, fp_outs):
    """Phase 18 (c).  Returns B1 launches."""
    from paddle_tpu_torch.serving import (Engine, FaultInjector,
                                          NoFreeBlocks, WatchdogTimeout)
    zero_ragged_counts(ragged_mod)
    runs = []
    t0 = time.perf_counter()
    for _ in range(2):
        runs.append(storm_run(model, reqs, seed=11))
    wall = time.perf_counter() - t0
    eng, handles, log, errors = runs[0]
    ok = [i for i, h in enumerate(handles) if h.error is None]
    for h in handles:
        if h.error is not None:
            check(any(n in repr(h.error) for n in INJECTED),
                  f"phase 18 (c): a request failed with {h.error!r}, not "
                  "an injected error")
    check(ok, "phase 18 (c): no request survived the storm")
    g_eq, g_n, s_eq, s_n = check_against(
        model, [reqs[i] for i in ok], [handles[i].result(0) for i in ok],
        [fp_outs[i] for i in ok], "phase 18 (c) storm survivors")
    for i in ok:
        if reqs[i][1]:
            check(runs[1][1][i].error is None
                  and runs[1][1][i].result(0).tolist()
                  == handles[i].result(0).tolist(),
                  "phase 18 (c): a seeded survivor did not repeat")
    check(runs[1][2] == log and runs[1][3] == errors,
          "phase 18 (c): the same seed replayed another fault log")
    check(len(log) >= 3, f"phase 18 (c): the storm fired {len(log)} faults")
    for e, _, _, _ in runs:
        e.prefix_cache.clear()
        check(e.block_pool.in_use() == 0,
              "phase 18 (c): the storm leaked KV blocks")
    dispatches = sum(r[0].ragged_dispatches for r in runs)
    b1 = ragged_counts(ragged_mod)["ragged_paged_attention"]
    check(b1 == dispatches * N_LAYERS,
          f"phase 18 (c): B1 launched {b1} times, not {dispatches} "
          f"dispatches x {N_LAYERS}")
    sites = sorted({s for _, s in log})
    print(f"phase 18 (c) storm (seed 11, ticks {STORM_TICKS}, rates "
          f"{STORM_RATES}, watchdog_s {STORM_WATCHDOG_S}): faults fired "
          f"{len(log)} at sites {sites}, step errors {errors}, survivors "
          f"{len(ok)}/12 (greedy equal to phase 4's {g_eq}/{g_n}, seeded "
          f"{s_eq}/{s_n}), the second run replayed the same log and "
          f"outcomes, pools at refcount 0, watchdog_fires "
          f"{eng.registry.get('serving.watchdog_fires').value:.0f}, "
          f"wall_s {wall:.3f} for both runs [{card}]", flush=True)
    # a pool exhaustion at the admission gate (tick 3): the popped
    # request goes back to the queue's head and nothing is lost
    inj = FaultInjector(seed=0).at(3, "pool_exhaust")
    eng = Engine(model, num_slots=8, max_seq_len=1024, kv_block_size=16,
                 prefill_chunk=64, faults=inj)
    eng.step()
    eng.step()
    handles = [eng.submit(p, max_new_tokens=32, **kw) for p, kw in reqs[:4]]
    raised = None
    try:
        eng.step()
    except NoFreeBlocks as e:
        raised = e
    check(raised is not None and inj.log == [(3, "pool_exhaust")],
          f"phase 18 (c): the pinned pool_exhaust did not raise at tick 3 "
          f"({inj.log})")
    check(not any(h.done() for h in handles)
          and eng.queue.depth() == len(handles),
          "phase 18 (c): a pool exhaustion at the gate lost a request")
    eng.run_until_idle()
    check_against(model, reqs[:4], [h.result(1) for h in handles],
                  fp_outs[:4], "phase 18 (c) after the pool exhaustion")
    check(eng.registry.get("serving.faults_injected").value == 1,
          "phase 18 (c): serving.faults_injected != 1")
    check_no_leak(eng, "phase 18 (c) pool exhaustion")
    dispatches += eng.ragged_dispatches
    print(f"phase 18 (c) pool_exhaust: NoFreeBlocks at tick 3's admission "
          f"gate, the 4 queued requests kept their places and served equal "
          f"to phase 4's, pool at refcount 0", flush=True)
    # a d2h hang under the watchdog: recorded with its in-flight ticks
    inj = FaultInjector(seed=0, hang_s=30.0).at(8, "d2h_hang")
    eng = Engine(model, num_slots=8, max_seq_len=1024, kv_block_size=16,
                 prefill_chunk=64, faults=inj, watchdog_s=1.0)
    for p, kw in reqs[:4]:
        eng.submit(p, max_new_tokens=32, **kw)
    raised = None
    t0 = time.perf_counter()
    for _ in range(40):
        try:
            eng.step()
        except WatchdogTimeout as e:
            raised = e
            break
    stalled = time.perf_counter() - t0
    check(raised is not None, "phase 18 (c): the watchdog never fired")
    fr = eng.last_flight["metadata"]["flight-recorder"]
    in_flight = fr["async"]["in_flight"]
    check(eng.registry.get("serving.watchdog_fires").value >= 1
          and in_flight and fr["tick"] == 8,
          f"phase 18 (c): flight record without in-flight ticks: {fr}")
    handles = [eng.submit(p, max_new_tokens=32, **kw) for p, kw in reqs[:4]]
    eng.run_until_idle()
    check_against(model, reqs[:4], [h.result(1) for h in handles],
                  fp_outs[:4], "phase 18 (c) after the watchdog")
    eng.stop()
    dispatches += eng.ragged_dispatches
    b1 = ragged_counts(ragged_mod)["ragged_paged_attention"]
    check(b1 == dispatches * N_LAYERS,
          f"phase 18 (c): B1 launched {b1} times, not {dispatches} "
          f"dispatches x {N_LAYERS}")
    print(f"phase 18 (c) watchdog: a d2h_hang at tick 8 converted to "
          f"WatchdogTimeout after {stalled:.3f} s (watchdog_s 1.0); "
          f"last_flight holds ticks {[t['tick'] for t in in_flight]} in "
          f"flight; the engine served 4 requests again, equal to phase 4's",
          flush=True)
    return b1


def fleet_phase(card, model, reqs, fp_outs):
    """Phase 18 (d): ``spawn_serving_fleet`` of two gpt2-medium replicas
    on the card behind ``routerd``; replica 0 gets SIGTERM mid-stream.
    The replicas draw their weights from seed 0 as this process did: the
    routed and drained streams equal to phase 4's show that they hold
    the same ones."""
    import numpy as np
    import urllib.request
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.distributed.launch import spawn_serving_fleet
    from paddle_tpu_torch.serving import (HttpReplicaClient, Router,
                                          RouterPolicy, RouterServer)
    t0 = time.perf_counter()
    with spawn_serving_fleet(2, config="gpt2-medium", device="cuda",
                             seed=0, num_slots=8, max_seq_len=1024,
                             kv_block_size=16, prefill_chunk=64, peers=True,
                             log_dir=FLEET_DIR,
                             ready_timeout_s=300.0) as fleet:
        boot = time.perf_counter() - t0
        router = Router({f"r{i}": HttpReplicaClient(u, timeout_s=600)
                         for i, u in enumerate(fleet.urls)},
                        policy=RouterPolicy(seed=0), kv_block_size=16,
                        registry=monitor.StatRegistry())
        with RouterServer(router) as rs:
            router.probe_once()
            box = {}

            def run():
                box["outs"], box["wall"] = post_all(rs.address, reqs)

            import threading
            th = threading.Thread(target=run, daemon=True)
            th.start()
            deadline = time.monotonic() + 120.0
            live = 0
            while time.monotonic() < deadline and th.is_alive():
                with urllib.request.urlopen(fleet.urls[0]
                                            + "/debug/requests",
                                            timeout=30) as r:
                    dbg = json.loads(r.read())
                live = sum(1 for s in dbg["slots"]
                           if s["state"] == "decoding"
                           and s.get("generated", 0) >= 1)
                if live:
                    break
                time.sleep(0.005)
            check(live, "phase 18 (d): replica 0 never held a live stream")
            fleet.procs[0].terminate()
            fleet.procs[0].wait(timeout=300)
            th.join(timeout=900)
            check(not th.is_alive(), "phase 18 (d): routed requests hung")
        outs, wall = box["outs"], box["wall"]
    with open(os.path.join(FLEET_DIR, "replica.0.log")) as f:
        log = f.read()
    m = re.search(r"drain: migrated=(\d+) fallback=(\d+) lost_tokens=(\d+)",
                  log)
    check(m is not None, f"phase 18 (d): no drain line in replica 0's log:"
          f"\n{log[-2000:]}")
    check(int(m.group(3)) == 0, f"phase 18 (d): {m.group(0)}")
    g_eq, g_n, s_eq, s_n = check_against(
        model, reqs, [np.asarray(o) for o in outs], fp_outs,
        "phase 18 (d) fleet")
    print(f"phase 18 (d) fleet: 2 gpt2-medium replicas up in {boot:.1f} s, "
          f"12 requests over routerd, "
          f"replica 0 SIGTERM with {live} live streams -> {m.group(0)}; "
          f"greedy_equal_to_phase4 {g_eq}/{g_n} seeded_equal {s_eq}/{s_n} "
          f"wall_s {wall:.3f} [{card}]", flush=True)


def fleet_features_phase(card, ragged_mod, model, reqs, fp_outs, model_q,
                         q_outs, phase4_tps):
    """Phase 18: migration, the front ends, faults and a real-process
    fleet on phase 4's model and traffic.  Returns (B1 launches, B2
    launches) of its in-process serves."""
    t0 = time.perf_counter()
    b1, b2 = migration_phase(card, ragged_mod, model, reqs, fp_outs,
                             model_q, q_outs)
    gc.collect()
    b1 += front_end_phase(card, ragged_mod, model, reqs, fp_outs,
                          phase4_tps)
    gc.collect()
    b1 += fault_phase(card, ragged_mod, model, reqs, fp_outs)
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    fleet_phase(card, model, reqs, fp_outs)
    print(f"phase 18 wall_s {time.perf_counter() - t0:.1f}", flush=True)
    return b1, b2


# -- phase 5 --------------------------------------------------------------
# (B, H, S, D, dtype, n_documents): the training slice's shape first
FLASH_CASES = {
    "slice_bf16": (4, 16, 2048, 128, "bfloat16", 0),
    "fp32": (1, 16, 2048, 128, "float32", 0),
    "hd64_bf16": (2, 16, 2048, 64, "bfloat16", 0),
    "segments_bf16": (2, 16, 2048, 128, "bfloat16", 4),
}


def flash_inputs(case):
    """q, k, v, do [B, S, H, D] from a seeded generator, and int32
    segment ids of packed documents with uneven lengths (None for 0)."""
    import numpy as np
    import torch
    B, H, S, D, dtype, ndoc = FLASH_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                   .to(dt) for _ in range(4))
    seg = None
    if ndoc:
        rng = np.random.RandomState(2)
        ids = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = np.sort(rng.choice(np.arange(64, S - 64), ndoc - 1,
                                      replace=False))
            ids[b] = np.searchsorted(cuts, np.arange(S), side="right")
        seg = torch.tensor(ids, device="cuda")
    return q, k, v, do, seg


def flash_bound_ms(kernel, q):
    """Least time for a kernel's work at causal attention without segment
    ids (the slice's case): causal FLOPs (per visible (query, key) pair
    and head: 4 D for QK^T and PV forward, 8 D for dK/dV's recomputed
    QK^T, dO V^T, P^T dO and dS^T Q, 6 D for dQ's QK^T, dO V^T and dS K)
    over the peak rate of the input dtype, or bytes (each input read
    once, each output written once) over the memory rate; the larger."""
    B, S, H, D = q.shape
    pairs = B * H * S * (S + 1) // 2
    n, item = q.numel(), q.element_size()
    rows = B * H * S * 4                    # one f32 per row: lse, di
    flops, nbytes = {
        "fwd": (4 * pairs * D, 4 * n * item + rows),
        "bwd_dkv": (8 * pairs * D, 6 * n * item + 2 * rows),
        "bwd_dq": (6 * pairs * D, 5 * n * item + 2 * rows),
    }[kernel]
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def cuobjdump():
    """The toolkit's cuobjdump, or the copy in Triton's package; None if
    neither exists."""
    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    return next((c for c in cands if c and os.path.exists(c)), None)


def flash_sass_counts(build):
    """{flash kernel function: (HGMMA, HMMA)}: the tensor-core instructions
    (wgmma, mma.sync) in each flash kernel's SASS, by ``cuobjdump -sass``
    on the built libraries.  None when no cuobjdump exists."""
    exe = cuobjdump()
    if exe is None:
        return None
    counts = {}
    for name in ("flash_attention", "flash_attention_sm90"):
        lib = build._paths(name)[1]
        sass = subprocess.run([exe, "-sass", lib], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        fn = None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                fn = found.group(1)
                counts[fn] = [0, 0]
            elif fn is not None and "HGMMA" in line:
                counts[fn][0] += 1
            elif fn is not None and "HMMA" in line:
                counts[fn][1] += 1
    return {fn: tuple(c) for fn, c in counts.items() if "flash" in fn}


def print_flash_sass(build):
    counts = flash_sass_counts(build)
    if counts is None:
        print("sass: cuobjdump not found (no tensor-core count)", flush=True)
        return
    for fn, (hgmma, hmma) in sorted(counts.items()):
        print(f"sass {fn}: HGMMA {hgmma} HMMA {hmma}", flush=True)


def flash_phase(fa):
    """Every case: the three kernels against their plain versions; at the
    slice's shape, times and bounds.  Returns {kernel: result} for the
    slice's shape."""
    import torch
    import torch.nn.functional as F
    results = {}
    for case, (B, H, S, D, dtype, _) in FLASH_CASES.items():
        q, k, v, do, seg = flash_inputs(case)
        scale = D ** -0.5
        kw = dict(causal=True, sm_scale=scale)
        o, lse = fa.flash_fwd(q, k, v, seg, **kw)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, di, seg)
        dk, dv = fa.flash_bwd_dkv(*args, **kw)
        dq = fa.flash_bwd_dq(*args, **kw)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, do)]
        want_o, want_lse = fa.flash_fwd_ref(*f32[:3], seg, **kw)
        ref_args = (*f32, want_lse, di, seg)
        want_dk, want_dv = fa.flash_bwd_dkv_ref(*ref_args, **kw)
        want_dq = fa.flash_bwd_dq_ref(*ref_args, **kw)
        if dtype == "float32":
            tol_o, tol_g = (0.0, 1e-5), (0.0, 1e-4)
        else:
            tol_o = tol_g = (2e-2, 2e-2)
        errs, rels = {}, {}
        for kernel, pairs, tol in (
                ("fwd", ((o, want_o), (lse, want_lse)), tol_o),
                ("bwd_dkv", ((dk, want_dk), (dv, want_dv)), tol_g),
                ("bwd_dq", ((dq, want_dq),), tol_g)):
            rels[kernel] = 0.0
            for got, want in pairs:
                check(bool(torch.isfinite(got).all()),
                      f"flash {kernel} {case}: non-finite output")
                torch.testing.assert_close(got.float(), want, rtol=tol[0],
                                           atol=tol[1])
                # a fault small per element but systematic (late causal
                # rows of o are ~0.03 in size) still moves the norm
                rel = float((got.float() - want).norm() / want.norm())
                check(rel <= FLASH_REL_TOL,
                      f"flash {kernel} {case}: relative L2 error "
                      f"{rel:.3e} over {FLASH_REL_TOL}")
                rels[kernel] = max(rels[kernel], rel)
            errs[kernel] = max(float((g.float() - w).abs().max())
                               for g, w in pairs)
        print(f"flash {case} (B={B} H={H} S={S} D={D} {dtype} causal"
              f"{' segments' if seg is not None else ''}): max_abs_err "
              + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + " rel_l2_err "
              + " ".join(f"{n} {e:.3e}" for n, e in rels.items())
              + f" (tolerance rtol {tol_o[0]} atol {tol_o[1]} fwd, rtol "
              f"{tol_g[0]} atol {tol_g[1]} bwd, relative L2 "
              f"{FLASH_REL_TOL} on every output)", flush=True)
        if dtype == "float32":
            scalar_ms = {
                n: cuda_time_ms(fn, iters=5, warmup=1) for n, fn in (
                    ("fwd", lambda: fa.flash_fwd(q, k, v, seg, **kw)),
                    ("bwd_dkv", lambda: fa.flash_bwd_dkv(*args, **kw)),
                    ("bwd_dq", lambda: fa.flash_bwd_dq(*args, **kw)))}
            print(f"flash {case} (scalar route) ms: "
                  + " ".join(f"{n} {t:.4f}" for n, t in scalar_ms.items()),
                  flush=True)
        if case != "slice_bf16":
            continue
        kernel_fns = {
            "fwd": lambda: fa.flash_fwd(q, k, v, seg, **kw),
            "bwd_dkv": lambda: fa.flash_bwd_dkv(*args, **kw),
            "bwd_dq": lambda: fa.flash_bwd_dq(*args, **kw)}
        plain_fns = {
            "fwd": lambda: fa.flash_fwd_ref(q, k, v, seg, **kw),
            "bwd_dkv": lambda: fa.flash_bwd_dkv_ref(*args, **kw),
            "bwd_dq": lambda: fa.flash_bwd_dq_ref(*args, **kw)}
        sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sdo = do.transpose(1, 2).contiguous()
        with torch.no_grad():
            sdpa_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, is_causal=True), iters=10)
        sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
        sdpa_bwd = cuda_time_ms(lambda: torch.autograd.grad(
            sout, (sq, sk, sv), sdo, retain_graph=True), iters=10)
        print(f"flash library: scaled_dot_product_attention(is_causal) "
              f"bf16 forward {sdpa_fwd:.4f} ms, backward (dq, dk, dv in one "
              f"autograd call) {sdpa_bwd:.4f} ms, forward+backward "
              f"{sdpa_fwd + sdpa_bwd:.4f} ms", flush=True)
        # SDPA's backward gives dq, dk and dv in one call: it is the
        # yardstick of the two backward kernels together
        library = {"fwd": (sdpa_fwd, ["flash_fwd"]),
                   "bwd_dkv": (sdpa_bwd, ["flash_bwd_dkv", "flash_bwd_dq"]),
                   "bwd_dq": (sdpa_bwd, ["flash_bwd_dkv", "flash_bwd_dq"])}
        for kernel in FLASH_KERNELS:
            ms = cuda_time_ms(kernel_fns[kernel], iters=10, warmup=2)
            plain_ms = cuda_time_ms(plain_fns[kernel], iters=3, warmup=1)
            bound, bound_by = flash_bound_ms(kernel, q)
            results[kernel] = dict(
                max_abs_err=errs[kernel], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by,
                library_ms=library[kernel][0],
                library_covers=library[kernel][1])
            print(f"kernel flash_{kernel} bf16: max_abs_err "
                  f"{errs[kernel]:.3e} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"bound_ms {bound:.4f} ({bound_by})", flush=True)
        del sq, sk, sv, sout
    torch.cuda.empty_cache()
    return results


# -- phase 6 --------------------------------------------------------------
TRAIN_B, TRAIN_S, TRAIN_TIMED = 4, 2048, 5


def flash_counts(fa):
    return {n: op.launches for n, op in fa.KERNEL_OPS.items()}


def zero_flash_counts(fa):
    for op in fa.KERNEL_OPS.values():
        op.launches = 0


def train_batch(vocab, batch, seq, seed):
    import numpy as np
    import torch
    ids = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))
    ids = torch.tensor(ids.astype(np.int64), device="cuda")
    return ids[:, :-1], ids[:, 1:]


def train_phase(card, fa):
    import math
    import torch
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    model = GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.1,
                                 fused_loss=True).to(torch.bfloat16)
    check(len(model.blocks) == N_LAYERS, "gpt3-1.3b has 24 layers")
    n_params = sum(p.numel() for p in model.parameters())
    E = model.blocks[0].attn.hidden_size
    V = model.head.lm_head.weight.shape[0]
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, opt)
    x, y = train_batch(V, TRAIN_B, TRAIN_S, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(fa)
    t_warm = time.perf_counter()
    losses = [step.step([x, y])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm_s = t0 - t_warm
    for _ in range(TRAIN_TIMED):
        losses.append(step.step([x, y]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts(fa)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    steps = TRAIN_TIMED + 1
    for name, n in launches.items():
        check(n == N_LAYERS * steps,
              f"flash {name} launched {n} times in {steps} steps, not "
              f"{N_LAYERS} a step")
    check(all(math.isfinite(l) for l in losses), f"non-finite loss {losses}")
    expect0 = math.log(V) + E * 0.02 ** 2 / 2
    check(abs(losses[0] - expect0) < 0.1,
          f"step-0 loss {losses[0]:.4f} is not within 0.1 of "
          f"ln V + E * 0.02^2 / 2 = {expect0:.4f}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    tokens = TRAIN_B * TRAIN_S * TRAIN_TIMED
    print(f"train gpt3-1.3b bf16: params {n_params} B {TRAIN_B} S "
          f"{TRAIN_S} losses " + " ".join(f"{l:.4f}" for l in losses)
          + f" (step-0 expected {expect0:.4f}) warmup_s {warm_s:.3f} "
          f"timed_steps {TRAIN_TIMED} wall_s {wall:.3f} s_per_step "
          f"{wall / TRAIN_TIMED:.4f} tokens_per_s {tokens / wall:.1f} "
          f"peak_mem_gb {peak_gb:.2f} flash_launches {launches} [{card}]",
          flush=True)
    train_profile(step, x, y, card)
    del step, opt, model
    torch.cuda.empty_cache()
    return launches


def train_profile(step, x, y, card):
    """One more step under torch.profiler: device time by kernel and the
    device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.step([x, y])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"train profile: one step wall_s {wall:.3f} device_busy_s "
          f"{busy_ms / 1e3:.3f} busy_share {busy_ms / 1e3 / wall:.3f} "
          f"[{card}]", flush=True)
    dev.sort(key=lambda e: -e.self_device_time_total)
    for e in dev[:12]:
        print(f"train profile kernel: {e.self_device_time_total / 1e3:10.3f}"
              f" ms {e.count:6d}x {100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
              f"{e.key[:90]}", flush=True)


# -- phase 7 --------------------------------------------------------------
def model_compare_phase(fa):
    """Loss and every gradient of a 2-layer gpt3-1.3b-width model through
    the kernels and through the plain versions, on the same weights and
    batch."""
    import torch
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.nn.functional import attention as attn_mod

    model = GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.0,
                                 fused_loss=True, num_layers=2
                                 ).to(torch.bfloat16)
    V = model.head.lm_head.weight.shape[0]
    x, y = train_batch(V, 1, TRAIN_S, seed=1)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model(x, labels=y)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone()
                             for n, p in model.named_parameters()}

    before = flash_counts(fa)
    l_kernel, g_kernel = loss_and_grads()
    check(all(flash_counts(fa)[n] == before[n] + 2 for n in before),
          "the kernel path did not launch each flash kernel once a layer")
    real = attn_mod.flash_attention
    attn_mod.flash_attention = fa.flash_attention_ref
    try:
        l_plain, g_plain = loss_and_grads()
    finally:
        attn_mod.flash_attention = real
    check(abs(l_kernel - l_plain) <= 1e-3 * abs(l_plain),
          f"loss through the kernels {l_kernel} vs plain {l_plain}")
    worst = 0.0
    for n, gp in g_plain.items():
        rel = float((g_kernel[n] - gp).norm() / gp.norm().clamp(min=1e-30))
        check(rel <= 2e-2, f"gradient {n}: relative L2 error {rel:.3e}")
        worst = max(worst, rel)
    print(f"model kernel vs plain (gpt3-1.3b width, 2 layers, B=1, S="
          f"{TRAIN_S}, bf16): loss {l_kernel:.6f} vs {l_plain:.6f}, worst "
          f"gradient relative L2 error {worst:.3e} over {len(g_plain)} "
          f"parameters (tolerance loss rtol 1e-3, gradients 2e-2)",
          flush=True)
    del model
    torch.cuda.empty_cache()


def main(argv):
    import torch
    cards = int(argv[argv.index("--cards") + 1]) if "--cards" in argv else 1
    if cards not in (1, 4):
        print("chip_smoke: --cards takes 1 (the default) or 4",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ not found beside "
              "chip_smoke.py; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    print(f"card: {card}", flush=True)

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attn as ragged_mod
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {len(reports)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry", "Performance")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    print_flash_sass(_build)

    def lap(phase):
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    if "--depth-ab" in argv:
        depth_ab_phase(card, int(argv[argv.index("--depth-ab") + 1]))
        lap("depth A/B")
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if cards == 4:
        four_card_phase(card, ragged_mod)
        lap("four-card mesh")
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    kres = kernel_phase(ragged_mod)
    qres = quant_kernel_phase(ragged_mod)
    mres = mesh_kernel_phase(ragged_mod)
    lap("3, 8, 13 (ragged kernels)")
    fres = flash_phase(fa)
    lap("5 (flash kernels)")
    zero_flash_counts(fa)
    zero_ragged_counts(ragged_mod)
    launches, model_fp, reqs, fp_outs, fp_tps = slice_phase(card,
                                                            ragged_mod)
    lap("4 (fp32 slice)")
    w_outs = weight_slice_phase(card, ragged_mod, reqs)
    lap("9 (weight-only int8 slice)")
    model_q, q_outs, int8_launches = int8_slice_phase(card, ragged_mod,
                                                      reqs, w_outs)
    lap("10 (int8 KV + weights slice)")
    gather_launches = gather_slices_phase(card, ragged_mod, reqs, model_fp,
                                          model_q, q_outs)
    capacity_phase(model_fp, card)
    lap("11, 12 (gather slices, capacity)")
    mesh_launches, mesh_outs = mesh_slice_phase(card, ragged_mod, model_fp,
                                                reqs, fp_outs)
    lap("14 (mesh serving)")
    depth_phase(card, ragged_mod, model_fp, reqs, fp_outs)
    sync_free_phase(card, model_fp, reqs, fp_outs)
    spec_phase(card, ragged_mod, model_fp, reqs, fp_outs)
    preempt_phase(card, model_fp, reqs)
    mesh_depth_phase(card, ragged_mod, model_fp, reqs, mesh_outs)
    lap("15 (pipelined, speculative and preempted serving)")
    check(sum(flash_counts(fa).values()) == 0,
          "the serving path launched a flash kernel")
    launches += xla_phase(card, ragged_mod, fa, model_fp, reqs, fp_outs)
    lap("16 (a)-(e) (the XLA and monolithic paths)")
    b1, b2 = serving_features_phase(card, ragged_mod, model_fp, reqs, fp_outs)
    launches += b1
    int8_launches += b2
    lap("17 (generate, draft model, LoRA, offload, streaming)")
    check(sum(flash_counts(fa).values()) == 0,
          "phase 17 launched a flash kernel")
    b1, b2 = fleet_features_phase(card, ragged_mod, model_fp, reqs, fp_outs,
                                  model_q, q_outs, fp_tps)
    launches += b1
    int8_launches += b2
    lap("18 (migration, front ends, faults, fleet)")
    check(sum(flash_counts(fa).values()) == 0,
          "phase 18 launched a flash kernel")
    del model_fp, model_q
    # a host-tier engine is a reference cycle (its prefix cache's evict
    # hook is a bound method of it): collect phase 17's before the
    # training phase measures its peak memory
    gc.collect()
    torch.cuda.empty_cache()
    bucket_fwd = bucket_phase(card, ragged_mod, fa)
    lap("16 (f) (bucketed prefill)")
    zero_ragged_counts(ragged_mod)
    flash_launches = train_phase(card, fa)
    flash_launches["fwd"] += bucket_fwd
    check(sum(ragged_counts(ragged_mod).values()) == 0,
          "the training path launched a ragged kernel")
    model_compare_phase(fa)
    lap("6, 7 (training)")

    f32 = kres["float32"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attn.cu",
        "replaces": "paddle_tpu/ops/ragged_paged_attn.py:125",
        "launches": launches,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "library_covers": ["ragged_paged_attention"],
    }]
    for name, source, replaces, n in (
            ("ragged_paged_attention_int8", "ragged_paged_attn.cu",
             "paddle_tpu/ops/ragged_paged_attn.py:141", int8_launches),
            ("ragged_gather_attention", "ragged_paged_attn.cu",
             "paddle_tpu/ops/ragged_paged_attn.py:232", gather_launches)):
        r = qres[name, "float32"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": n,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_covers": [name],
        })
    r = mres["stream_fp32"]
    kernels.append({
        "name": "sharded_ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attn.cu",
        "sources": ["paddle_tpu_torch/csrc/ragged_paged_attn.cu",
                    "paddle_tpu_torch/ops/ragged_paged_attn.py"],
        "replaces": "paddle_tpu/ops/ragged_paged_attn.py:377",
        "launches": mesh_launches,
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "library_covers": ["sharded_ragged_paged_attention"],
        "mesh": list(MESH_SHAPE),
        "device_ms": r["device_ms"],
    })
    for kernel in FLASH_KERNELS:
        r = fres[kernel]
        # the slice's bf16 calls: the tensor-core kernels
        source = {"tensor_core": "flash_attention_sm90.cu",
                  "scalar": "flash_attention.cu"}[
                      fa.entry(kernel, torch.bfloat16, 128)[0]]
        kernels.append({
            "name": f"flash_{kernel}",
            "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": FLASH_REPLACES[kernel],
            "launches": flash_launches[kernel],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_covers": r["library_covers"],
        })
    line = {"kernels": kernels, "card": card}
    print(json.dumps(line), flush=True)
    print(f"{card}", flush=True)
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
