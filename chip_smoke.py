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
   bf16 and fp16 instantiations of the forward, dK/dV and dQ kernels of
   ``flash_attention_sm90.cu`` beside the scalar ones.
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
4. The slice at full width: ``GPTModel.from_config("gpt2-medium")`` cut
   to ``SERVE_LAYERS`` = 8 of its 24 layers (the depth of every serving
   phase, for the time limit), in fp32 from a seed, ``Engine(num_slots=8, max_seq_len=1024,
   kv_block_size=16, prefill_chunk=64)``, 12 requests (prompts of 17 to
   900 tokens, four sharing a 48-token system prompt, ten greedy and two
   seeded), ``run_until_idle()``.  Checks: every greedy token is the
   argmax of the dense forward over prompt + output (teacher forcing;
   near ties under a 1e-4 margin are counted, not failed), the kernel
   launched exactly once per layer and ragged dispatch, prefix hits > 0, and
   the seeded streams repeat on a second engine.  A third run of the
   same traffic with ticks 32-33 under ``torch.profiler`` prints the
   device's busy share in that window and the kernels that take the most
   device time (every profiled serve covers the same window: the trace
   of a whole serve takes minutes to process).
5. Flash kernels against their plain versions (``ops/flash_attention.py``):
   the training slice's shape (B=4, H=16, S=2048, hd=128, bf16,
   causal), an fp32 case, an hd=64 case, a case with segment ids
   (four packed documents of uneven lengths), and the slice's shape in
   fp16 with and without segment ids (what ``auto_cast(dtype=
   "float16")`` gives the kernels), and phase 21's per-rank shapes in
   bf16 ([2, 2048, 8, 128] on an mp rank, [1, 2048, 16, 128] on a data
   rank and a pipeline micro-batch).  bf16 and fp16 run the tensor-core
   kernels (``csrc/flash_attention_sm90.cu``, one template instantiated
   for each), fp32 the scalar ones (``csrc/flash_attention.cu``).  fp32
   holds o and lse at atol 1e-5 and the gradients at atol 1e-4
   (summation order); bf16 and fp16 hold every output at rtol 2e-2 /
   atol 2e-2 against the plain version computed in f32 from the same
   bf16 / fp16 values (rounding of the outputs, and of P and dS before
   their products, as the TPU kernel rounds them); every case also holds
   each output to a relative L2 error of 1e-2, which a small but
   systematic fault on the late causal rows (where o is ~0.03 in size)
   would pass per element but not in norm.  At the slice's shape, in
   bf16 and in fp16, it times the forward, dK/dV and dQ kernels, their
   plain versions and ``scaled_dot_product_attention`` in the same dtype
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
   model, as phase 4; B1 launched once per layer and dispatch.
10. int8 KV + int8 weights slice at full width: the same
   traffic through ``Engine(kv_dtype="int8", weight_dtype="int8")`` on
   another fresh model.  Checks: B2 launched once per layer and dispatch and B1
   and B3 not at all, ``QuantKV`` pools, prefix hits > 0, seeded streams
   repeat on a second engine, and the greedy streams equal those of the
   same engine with B2 swapped for its plain version over the four
   requests with prompts of at most 400 tokens (the plain version walks
   the blocks in Python: the whole traffic took 114 s), except from a
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
   margin rule).  In both, B3 launched once per layer and dispatch and
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
   second run profiled as phase 4's over ticks 32-33 (busy share, top
   kernels, and the device time under B4's and the collectives' profiler
   labels).  int8 pools: greedy
   streams equal to an unsharded ``kv_dtype="int8"`` engine's on the
   same fp32 weights except at int8 near ties (phase 10's rule, margin
   < 1e-3 on the mesh engine's own logits).  Gather body: greedy streams
   equal to the mesh fp32 ones except at near ties (margin < 1e-4 on its
   own logits).  In each, the path's kernel and B4 launched once per layer
   and dispatch (one launch for the card's group of ranks), and no other
   ragged kernel.
15. Pipelined, speculative and preempted serving, on phase 4's fp32
   model and traffic.  Every serve above runs at the engine's default
   ``async_depth=2`` (tick N+1 dispatched before tick N is consumed).
   A/B of depth: fp32 serves at ``async_depth`` 1 and 2, each printing
   tokens/s and the loop's mean ``serving.tick_overlap_ms`` /
   ``serving.d2h_wait_ms``; every stream, greedy and seeded, equal
   across depths and to phase 4's (the greedy ones the dense argmax),
   then a ``profile_phase`` window at depth 1 (phase 4's is depth 2's;
   busy share, kernels
   a tick).  Each serve's line adds the tracer's host-side means:
   tick, dispatch (the host issuing a tick's launches), emit.
   Sync-free dispatch: the traffic once more, every tick that starts
   with clean state and can admit nothing run under
   ``torch.cuda.set_sync_debug_mode("error")`` (at least 20, one with a
   sampling lane and one with a final-chunk lane among them; the
   consume's wait on its event lifted out).  Speculative decoding:
   ``spec_k=3`` with prompt lookup, B1 launched once per layer and dispatch,
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
   (a), (b), (d), (e) and B1 launched once per layer and ragged dispatch in (c),
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
   buffered tokens.  B1 (B2 in (d) int8) launched once per layer and dispatch in
   every ragged serve, none in (c)'s XLA serve; no flash kernel.
18. Migration, the front ends, faults and the fleet, on phase 4's fp32
   model and traffic.  (a) Two ragged engines: every request exported
   from A after 8 tokens (``migrate_out(deliver="return")``, the demands
   registered at submit) and imported by B, every other payload through
   its JSON wire form; the streams equal phase 4's (dense near ties and
   near-edge seeded draws excepted), every block adopted, both pools at
   refcount 0 afterwards, B1 launched once per layer and dispatch of A and B.
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
19. The GPT pretraining recipe at full width and depth.  (a)
   ``GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.1,
   fused_loss=True, use_recompute=True)`` in fp32 under
   ``TrainStep(amp_level="O1")``, ``AdamW`` over
   ``LinearWarmup(CosineAnnealingDecay(1e-4, T_max=100), 3, 0, 1e-4)``
   with ``ClipGradByGlobalNorm(1.0)``, B=4, S=2048, rows packed with 3-6
   documents of uneven lengths (numpy seed 0; the last row padded)
   through ``forward(..., labels, doc_lens=...)``; one warm-up step and 3
   timed steps.  Checks: losses finite, the first within 0.1 of ln V +
   E * 0.02^2 / 2, falling; each step's learning rate the scheduler's
   Python sequence; B5a launched 48 times a step (the recompute), B5b and
   B5c 24; no launch on the scalar fp32 route; the peak memory below one
   more step's without recompute.  Prints tokens/s (and the ratio to
   phase 6's), both peaks and a ``torch.profiler`` breakdown of one
   step.  (b) the same model with ``scan_layers=True``,
   ``amp.decorate(level="O2")`` to bf16, ``strategy.amp`` with
   ``use_pure_fp16`` and ``AdamW(multi_precision=False)``: 1 + 2 steps,
   the same loss checks, bf16 moments (its attention runs in f32, on
   the scalar kernels, as the JAX package's O2 promotes it).  (d)
   ``generate`` of 16 greedy tokens on (b)'s model equals an unrolled
   copy's.  (c) phase 7's comparison on this path: 2 layers, fp32
   weights, O1, recompute, a packed padded row, kernels against plain
   versions (loss rtol 1e-3, gradients relative L2 2e-2; B5a twice a
   layer).
20. The MoE and sequence-parallel GPT blocks, BERT and fp16.  (a)
   ``GPTModel.from_config("gpt2-medium", moe_experts=8, moe_every=2)``
   in fp32 from seed 0 (12 MoE blocks of 8 experts, k=2, capacity factor
   2.0) serves phase 4's traffic with phase 4's engine: B1 launched 24
   times a dispatch, the streams repeat on a second run, and over the
   four requests with prompts of at most 400 tokens the kernel path's
   greedy streams equal the same engine's with B1 swapped for its plain
   version, except from a first divergence at a near tie (margin < 1e-4
   on the plain engine's own logits); tokens/s, kernels a tick and busy
   share beside phase 4's.  (b) the same model trained at B=8, S=1024
   (AdamW, recompute, fused head + CE), 1 + 3 steps: losses finite and
   falling, the first within 0.1 of ln V + E * 0.02^2 / 2 once its aux
   loss is taken off; the aux loss and the peak printed.  (c)
   ``BertForSequenceClassification(BertModel.from_config("bert-base"),
   2)`` (``BASELINE.md`` config 3), B=32, S=128, attention masks of
   lengths 32-128 and labels from numpy seed 0 (a class-1 row is token
   type 1 throughout: a learnable synthetic pair task),
   ``TrainStep(amp_level="O1")`` with AdamW at ``bench.py``'s 2e-5, 1 + 3
   steps: losses finite and falling, no attention kernel
   launched (no TPU kernel runs on this path); samples/s and the peak.
   (d) ``ring_attention`` and ``ulysses_attention`` over ``build_mesh(
   sp=4)`` (four ranks on the card) at gpt2-medium's attention shape
   (B=2, S=1024, H=16, hd=64, fp32, causal): the output at atol 2e-5
   and dq/dk/dv at 1e-4 against the dense reference attention; then two
   steps of gpt2-medium with ``use_sp="ring"`` and no sp mesh (the
   degenerate single block), B=4, S=1024: losses finite, falling, no
   flash launch.  (e) one ``gpt3-1.3b`` step (fp32 weights) at B=4,
   S=2048 under ``auto_cast(dtype="float16")``: B5a, B5b and B5c launched
   24 times each, all in fp16, the loss and every gradient finite.
21. Training over a mesh: ``GPTModel.from_config("gpt3-1.3b",
   dropout=0.0, fused_loss=True, use_recompute=True)`` in fp32 from seed
   0 under ``amp_level="O1"`` (B5a-B5c in bf16) with ``AdamW(1e-4,
   0.01)``, B=4, S=2048, ids from numpy seed 0, over four meshes of four
   ranks on this card (``build_mesh(..., devices=[cuda:0] * 4)``): (1)
   ``dp=2, sharding=2`` with ``strategy.sharding`` stage 2, (2)
   ``sharding=4`` stage 3 (a unit gathered at a time), (3) ``dp=2,
   mp=2`` on ``to_tensor_parallel()`` of the same weights, (4)
   ``gpt_pipe_model("gpt3-1.3b")`` (the same weights from the same seed)
   over ``pp=4`` at B=8, ``accumulate_steps=8`` (one row a micro-batch,
   so that 1F1B's bound of 2P - 1 live micro-batches a stage is below
   M), once GPipe with
   ``strategy.recompute`` and once 1F1B.  One one-device ``TrainStep`` of
   the dense model on the same weights and batch (B=4, and B=8 for mesh
   4) is the reference.  Each run takes one warm-up step and two
   steps.  Checks:
   the first step's gradients, gathered to full tensors (``full_grads``;
   the TP and pipeline names and layouts mapped back to the dense
   model's), within a relative L2 error of 2e-2 of the reference's each;
   the three losses within rtol 1e-2 of the reference's; a second run of
   mesh 3 and of 1F1B from the same seed repeats its first two losses
   exactly; B5a launched 192 times a step and B5b and B5c 96 on meshes
   1-3 (4 ranks x 24 layers, the forward twice under recompute), 384 and
   192 on mesh 4 (8 micro-batches), none on the scalar route; 1F1B
   holding at most 2P - 1 = 7 stage inputs a stage between ticks, where
   GPipe holds M = 8 (``max_stored_inputs``), and peaking at most at
   GPipe's peak plus one gradient of ``post`` in bf16 and fp32 (0.62 GB:
   1F1B adds a micro-batch's gradient to the accumulated one, where
   GPipe's one backward makes it the accumulated one;
   ``check_1f1b_memory``; the peak of the two steps after the warm-up,
   both engines freeing the gradients at the start of a step).  Prints
   for each run s a step,
   tokens/s, the peak,
   the state reckoned over the ranks and the flash kernels a step; for
   mesh 3 a ``torch.profiler`` step (busy share, kernels a step, the
   device time under the collectives' ``mesh.*`` labels).  Before the
   runs it times B5a-B5c at mesh 3's per-rank shape ([2, 2048, 8, 128]
   bf16) beside ``scaled_dot_product_attention`` at that shape.
22. The rest of serving over the mesh (run after phase 18, on phase 4's
   fp32 model and traffic): (a) phase 16's five serves on phase 14's
   (2, 2) mesh of ``to_tensor_parallel()`` — every greedy token the dense
   argmax (phase 4's near-tie rule), every stream equal to phase 16's of
   the same serve except at near ties (host-mode seeded ones counted),
   the XLA serves launching no ragged kernel, (c) B4 over B1 once per layer
   and dispatch — and a profiled window of (a) (ticks 32-33) with its
   kernels a tick by launching op beside phase 16's; (b)
   ``weight_dtype="int8"`` on a ``(1, 2)`` mesh, streams equal to phase
   9's; (c) phase 17 (d)'s host-tier
   waves on the (2, 2) mesh at ``max_seq_len=512`` (fp32 pools, B1 under
   B4), restored streams equal to a no-cache mesh engine's; (d)
   phase 4's first six requests migrated after 8 tokens from the mesh to
   one device and back, streams equal to phase 4's, B4 and B1 counted
   per engine; each with its tokens/s, kernels a tick and busy share;
   (e) a conv net with the port's ``BatchNorm2D`` trained over dp2 on
   the card, losses, weights and running statistics within 1e-4 of the
   one-device step's.
23. The rest of training over a mesh, after phase 21 and on its B=8
   batch and one-device reference: (a) ``gpt_pipe_model("gpt3-1.3b")``
   over ``dp=2, pp=2`` at ``accumulate_steps=4`` (each micro-batch's two
   rows split over dp: one pipeline a data rank), GPipe with
   ``strategy.recompute`` and then 1F1B; (b) the same over ``mp=2,
   pp=2`` under GPipe, its embedding and head vocab-parallel
   (``tp_ends``) around dense blocks; each run one warm-up step and one
   step, held as phase 21 holds its runs (gradients, losses, the flash
   launches a step: B5a 384 a step in (a), 192 in (b)), and (a)'s 1F1B
   held to its GPipe as phase 21 holds pp4's (2P - 1 = 3 < M = 4 stage
   inputs; the peak bound with a gradient of ``post`` a pipeline).  (c)
   ZeRO-3 a unit at a time: phase 21's ``sharding=4`` stage-3 peak
   printed beside its ``dp=2, sharding=2`` stage-2 peak and the
   gather-all's 53.26 GB, and required below the stage-2 peak.  (d)
   ``gpt2-medium`` in fp32 (seed 0, dropout 0, AdamW), two steps at B=4,
   S=1024: LocalSGD (k=2) over ``dp=2, mp=2`` against LocalSGD written
   out (two models, each with its own AdamW, two eager steps a call over
   its rows, then the mean of every parameter), and DGC over ``dp=2,
   mp=2`` against DGC over ``dp=2`` alone; every parameter within
   relative L2 1e-6, DGC's losses equal and LocalSGD's within 1e-6; no
   flash launch.  Each run prints s a step, tokens/s, the peak and the
   flash launches a step.
24. The Paddle tensor layer (``core/``, ``ops/``): (a) every case of
   ``tests/torch_op_cases.py`` (every public op of ``ops/``, each Tensor
   dunder, a ``grad(create_graph=True)`` double grad) on the card
   against the CPU on the same numpy inputs, gradients included, at the
   cases' tolerances (fp32 rtol 1e-5 / atol 1e-6, transcendentals and
   reductions 1e-4 / 1e-5, linear algebra by reconstruction 1e-4,
   integer and bool exactly), every output on the card, and the random
   ops repeating under one seed; (b) gpt2-medium's token table [50304,
   1024] trained 3 steps through ``embedding(..., sparse=True)`` with
   SGD, Momentum, Adam, lazy Adam and lazy AdamW
   (``tests/torch_sparse_checks.py``: sparse equal to dense, lazy
   runs' untouched rows and moments bit-identical, lazy Adam's rows
   equal the rule row by row on the host), each run's ms a step, the
   gradient's bytes and the peak; (c) ``py_func`` on a card tensor; (d)
   the sequence ops over 8192 ragged tokens in 64 rows against the CPU.
   No kernel launches.
25. The Paddle ``nn`` layer system, written as a Paddle user writes it
   (``nn.Layer`` subclasses, handles, ``loss.backward()``,
   ``optimizer.step()``): (a) Vaswani et al. 2017's base Transformer
   (``nn.Transformer``'s defaults: d_model 512, 8 heads, 6 + 6 layers,
   FFN 2048, dropout 0.1) between a shared ``nn.Embedding(37000, 512)``
   and an ``nn.Linear(512, 37000)`` head, ``nn.CrossEntropyLoss``, Adam
   (beta2 0.98, epsilon 1e-9) with ``ClipGradByGlobalNorm(1.0)``, fp32,
   B=64 pairs of 128 tokens a side (the paper's 25,000-token batches cut
   to 8,192 for time), one warm-up and 3 timed steps on a seeded batch:
   every loss finite and the loss falling, the first loss (dropout off)
   equal to the port's CPU loss on the same weights and 4 pairs at rtol
   1e-4; prints ms a step, tokens/s, the peak and the kernels a step
   with a profiled step's busy share; (b) on (a)'s trained model,
   ``TransformerDecoder.gen_cache`` plus 32 one-token steps equal the
   full forward under ``generate_square_subsequent_mask`` at every
   position (atol 1e-4), the ``StaticCache`` made once; (c) the ``Layer``
   ``TransformerEncoder`` at base width, B=2, S=2048, bf16 under
   ``amp.auto_cast``, forward and backward: B5a, B5b and B5c launch 6
   times each (once a layer), and the loss equals the same encoder's on
   the plain attention at phase 7's rtol 1e-3; each gradient lies at
   most 1.5 times as far (relative L2) from the fp32 encoder's as the
   plain bf16 path's, or as 2e-2 where that is nearer, and within 2e-2
   of the plain path's where that lies within 2e-2 of fp32; (d) an LSTM
   encoder-decoder at PaddleNLP ``examples/machine_translation/seq2seq``
   widths (IWSLT'15 en-vi vocabularies 17,191 and 7,709, width 512, 2
   layers, ``max_grad_norm`` 5.0) trained 3 steps at batch 128, length
   50, then ``BeamSearchDecoder`` + ``dynamic_decode`` (beam 10, 50
   steps, 16 sources; the decoder cell two ``LSTMCell`` as one) on the
   card and on the CPU port with the same weights, each search also
   recorded step by step: before a source's first near tie (the
   beam-th and (beam + 1)-th candidates within 1e-4, or at the last
   step the best ``beam`` that close) its hypotheses after every step
   are the CPU's with scores within rtol 1e-4, a source with none has
   the CPU's ids exactly, the excused sources are counted and not all
   may be; (e) every case of ``tests/torch_nn_cases.py`` on
   the card against the CPU, forward and gradient, every output on the
   card.
26. The data pipeline and the high-level API (``io/``, the host library
   ``csrc/*.cc``, ``hapi/``, ``metric/``, ``nn/functional/sequence.py``):
   (a) ``BASELINE.md`` config 3 through ``hapi.Model``: BERT-base (seed
   0) behind a wrapper that takes padded ids (mask from pad id 0, token
   type 0), ``AdamW(2e-5, weight_decay=0.01)``, ``CrossEntropyLoss``,
   ``Accuracy``, ``amp_configs={"level": "O1"}``; 2,048 training and 512
   evaluation sentences of SST-2's shape (numpy seed 1234: lengths
   lognormal around a median of 24, clipped to 4-128, ids uniform, a
   marker token in every class-1 row) through ``DataLoader(batch_sampler=
   BucketedBatchSampler(batch_size=32, buckets=(32, 64, 128),
   shuffle=True, drop_last=True), num_workers=2)``; ``fit`` 48 steps,
   then ``evaluate`` and ``predict``.  Checks: the workers' batches equal
   ``num_workers=0``'s, array for array, through the native ordered
   queue; ``fit``'s losses equal a hand loop's (a fresh model of the same
   seed, ``TrainStep`` of the same recipe, the same ``paddle.seed``, the
   ``num_workers=0`` batches, dropout on) within 1e-5 relative;
   ``evaluate``'s accuracy is numpy's argmax of ``predict``'s logits
   exactly and its loss their mean CE within 1e-6; ``Model.save`` /
   ``load`` into a fresh model gives bit-identical logits and the next two
   ``train_batch`` losses within 1e-6 relative (the optimizer state came
   back); a ``torch.profiler`` window of 4 ``fit`` steps shows the batch
   uploads as pinned host-to-device copies on another stream than the
   step's; no flash or ragged launch; no new ``/dev/shm`` segment.  Prints
   samples/s (and its ratio to the hand loop's and to phase 20 (c)'s), the
   time blocked in ``next(feed)`` against a step's, the peak, ``summary``'s
   parameter count and ``flops`` at (32, 128).  (b) every public function
   of ``nn/functional/sequence.py`` over phase 24's ragged lengths (64
   rows, 8,192 tokens, one of 2,048) at width 768, fp32, on the card and
   on the CPU with the same inputs: outputs at rtol 1e-5 / atol 1e-5,
   integers exactly, the gradients of every pool type, softmax and conv
   too; ms a call by CUDA events.  (c) ``InMemoryDataset`` over four part
   files of 65,536 records of Criteo's dense part (13 counts and a label,
   numpy seed 0), loaded with 4 threads, ``local_shuffle``, 512-record
   batches through ``DeviceLoader`` to the card: the records equal the
   pure-Python engine's as a multiset; prints records/s of the load and
   of the walk.
27. Prints the ``kernels`` JSON line (B1's launches count phase 4's,
   phase 16 (c)'s, phase 17's and phase 18's in-process serves, phase
   20 (a)'s first serve and phase 22 (d)'s unsharded engines, B4's phase
   14's and phase 22's mesh serves, B2's phase 10's, phase 17 (d)'s and
   phase 18 (a)'s, B5a-B5c's phase 6's, phase 19 (a)'s, phase 21's and
   phase 23's and phase 25 (c)'s, B5a's phase 16 (f)'s too; the fp16
   entries phase 20 (e)'s), the card line and
   ``{"ok": true, "device": {...}}`` as the last line.  Each kernel's
   ``library_covers`` names the kernels its ``library_ms`` call does the
   work of: SDPA's one backward call gives dq, dk and dv, so both flash
   backward kernels carry its time.

With ``--depth-ab N`` it builds the kernels and runs only
``depth_ab_phase``: N pairs of the fp32 serve at async_depth 1 and 2.
With ``--profile-mesh`` it builds the kernels and runs only
``profile_mesh_phase``: phase 4's serve profiled unsharded and on the
(2, 2) mesh, each window's kernels a tick by launching op.
With ``--stage3`` it builds the kernels and runs only ``stage3_phase``:
phase 21's ``sharding=4`` stage-3 run with and without the blocks'
``use_recompute``.
With ``--tensor-layer`` it runs only phase 24, without building the
kernels.
With ``--nn`` it builds the flash kernels and runs only phase 25.
With ``--hapi`` it runs only phase 26, without building the kernels.
With ``--host-ab PARENT`` it runs phases 4 and 20 (a), (c), whose pace
the host sets, as the checkout at ``PARENT`` runs them and as this one
does, each in a process of its own, in the order PARENT, this, this,
PARENT (``--host-paths-of ROOT`` is one such run, with phase 4's serve
once more under cProfile), then the host time ``nn.functional``'s
handle wrapper adds to a call (``wrapper_cost``).
With ``--cards 4`` it builds the kernels and runs only
``four_card_phase``: the (2, 2) mesh serve over four cards beside the
same mesh on one card, both at the default ``async_depth=2``.

Needs the repository around it: alone in a directory it exits non-zero.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import io as io_mod
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
N_LAYERS = 24                      # gpt3-1.3b (and gpt2-medium) in training
# the serving phases' gpt2-medium, at full width, cut from 24 layers to
# this depth so that the whole smoke ends well inside its time limit
SERVE_LAYERS = 8
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

    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 num_layers=SERVE_LAYERS)
    check(len(model.blocks) == SERVE_LAYERS,
          f"the serving gpt2-medium has {SERVE_LAYERS} layers")
    reqs = traffic(model.embeddings.word_embeddings.weight.shape[0])
    rpa = ragged_mod.ragged_paged_attention
    rpa.launches = 0
    eng, outs, wall = serve(model, reqs, Engine)
    launches = rpa.launches
    check(launches == eng.ragged_dispatches * SERVE_LAYERS,
          f"kernel launches {launches} != ragged dispatches "
          f"{eng.ragged_dispatches} x {SERVE_LAYERS}")
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
# profiling a whole serve costs minutes of trace processing, and the
# twelve windows' traces took 141 s at 24 ticks (8 for the mesh's),
# 95.4 s at 8 on a slow host and 42.8 s at 4, so every window is 2 ticks,
# to keep the whole run inside its time limit with phase 26
PROFILE_TICKS = (32, 2)


PROFILES = {}                      # label -> (busy share, kernels a tick)
BREAKDOWNS = {}                    # label -> kernel_breakdown(...)
BREAKDOWN_TICKS = 2                # a breakdown's own window, when apart


def kernel_breakdown(prof, ticks):
    """Kernels a tick by the torch op that launched them (the innermost
    CPU op a kernel is attached to; the ragged kernels, launched through
    ctypes, under their wrapper's ``record_function``), and the kernels
    launched under each mesh label.  Returns ({op: (kernels a tick,
    device ms a tick)}, {label: kernels a tick})."""
    ops, regions = {}, {}
    evs = [e for e in prof.events() if e.device_type.name == "CPU"]

    def kernels_under(e):
        return len(e.kernels) + sum(kernels_under(c)
                                    for c in e.cpu_children)

    for e in evs:
        if e.kernels:
            n, ms = ops.get(e.name, (0, 0.0))
            ops[e.name] = (n + len(e.kernels),
                           ms + sum(k.duration for k in e.kernels) / 1e3)
        if e.name in MESH_REGIONS:
            regions[e.name] = regions.get(e.name, 0) + kernels_under(e)
    return ({k: (n / ticks, ms / ticks) for k, (n, ms) in ops.items()},
            {k: n / ticks for k, n in regions.items()})


def print_breakdown(label, base_label=None, top=25):
    """The kernels a tick of profile ``label`` by launching op, beside
    those of profile ``base_label`` (same window, another engine)."""
    ops, regions = BREAKDOWNS[label]
    base = BREAKDOWNS[base_label][0] if base_label is not None else {}
    total = sum(n for n, _ in ops.values())
    print(f"breakdown{label}: {total:.1f} kernels a tick attributed to "
          f"{len(ops)} ops" + (f" (against {sum(n for n, _ in base.values()):.1f}"
                               f" in profile{base_label})" if base else ""),
          flush=True)
    for name in sorted(ops, key=lambda k: -ops[k][0])[:top]:
        n, ms = ops[name]
        was = (f" was {base.get(name, (0.0, 0.0))[0]:8.1f} "
               f"delta {n - base.get(name, (0.0, 0.0))[0]:+8.1f}"
               if base_label is not None else "")
        print(f"breakdown{label} op: {n:8.1f} kernels/tick {ms:8.3f} "
              f"ms/tick{was} {name[:70]}", flush=True)
    for name, n in sorted(regions.items()):
        print(f"breakdown{label} region: {name} {n:.1f} kernels/tick",
              flush=True)


def profile_mesh_phase(card):
    """``--profile-mesh``: phase 4's traffic on a fresh gpt2-medium (seed
    0) profiled over ticks ``PROFILE_TICKS``, unsharded and on phase 14's
    (2, 2) mesh, both ragged; prints each window's kernels a tick by
    launching op, the mesh's beside the unsharded one's."""
    import torch
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 num_layers=SERVE_LAYERS)
    reqs = traffic(model.embeddings.word_embeddings.weight.shape[0])
    profile_phase(model, reqs, Engine, card, label=" unsharded",
                  ops=True, breakdown=True)
    tp = model.to_tensor_parallel()
    profile_phase(tp, reqs, Engine, card, label=" mesh", ops=True,
                  breakdown=True, mesh=one_card_mesh())
    print_breakdown(" unsharded")
    print_breakdown(" mesh", " unsharded")
    del tp, model
    torch.cuda.empty_cache()


def profile_phase(model, reqs, engine_cls, card, label="",
                  breakdown=False, ops=False, **engine_kw):
    """Where a tick's time goes: the same traffic once more, ticks
    ``PROFILE_TICKS`` (first, count) under torch.profiler
    (``profile_window``, with the kernels by launching op when
    ``breakdown``).  The serve then runs to its end; returns its
    streams."""
    first, count = PROFILE_TICKS
    eng, handles = submit_all(model, reqs, engine_cls, **engine_kw)
    for _ in range(first):
        eng.step()
    profile_window(eng, count, card, label, first=first, ops=ops,
                   breakdown=breakdown)
    eng.run_until_idle()
    return [h.result(timeout=1) for h in handles]


def profile_window(eng, count, card, label, first=None, ops=False,
                   breakdown=False):
    """``count`` ticks of ``eng`` under torch.profiler: prints the
    device's busy share of that window's wall time, its kernels a tick,
    the kernels that took the most device time in it, and (``ops``: the
    host's ops traced too) the device time of the kernels launched under
    the mesh's profiler labels (B4, the collectives) where the path has
    them; records the window in ``PROFILES`` under ``label``, and with
    ``breakdown`` the kernels a tick by launching op in ``BREAKDOWNS``:
    from this window when ``ops``, else from the ``BREAKDOWN_TICKS``
    ticks right after it, traced with the host's ops.  Profiler overhead
    stretches the window's wall time; the share is of this window.
    Tracing the host's ops costs tens of seconds of trace processing a
    mesh window, so the windows that report only busy share and kernels
    a tick trace the device alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_first = eng.ticks if first is None else first
    acts = ([ProfilerActivity.CPU] if ops else []) + [ProfilerActivity.CUDA]
    t_trace = time.perf_counter()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in dev)
    PROFILES[label] = (busy_ms / 1e3 / wall, launches / count)
    if breakdown and ops:
        BREAKDOWNS[label] = kernel_breakdown(prof, count)
    elif breakdown:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as traced:
            for _ in range(BREAKDOWN_TICKS):
                eng.step()
            torch.cuda.synchronize()
        BREAKDOWNS[label] = kernel_breakdown(traced, BREAKDOWN_TICKS)
        print(f"breakdown{label}: ticks {eng.ticks - BREAKDOWN_TICKS}-"
              f"{eng.ticks - 1} traced with the host's ops", flush=True)
    print(f"profile{label}: ticks {t_first}-{t_first + count - 1} of "
          f"{eng.ticks} async_depth {eng.async_depth} wall_s {wall:.3f} "
          f"device_busy_s {busy_ms / 1e3:.3f} busy_share "
          f"{busy_ms / 1e3 / wall:.3f} kernels_per_tick "
          f"{launches / count:.1f} trace_s "
          f"{time.perf_counter() - t_trace:.1f} [{card}]", flush=True)
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
        ms, n = regions.pop("sharded_ragged_paged_attention", (0.0, 0))
        print(f"profile{label} region: sharded_ragged_paged_attention "
              f"{ragged + ms:10.3f} ms device {n:6d}x "
              f"{100 * (ragged + ms) / busy_ms:5.1f}% of busy (its kernels "
              f"{ragged:.3f} ms, torch ops under it {ms:.3f} ms)", flush=True)
        for key, (ms, n) in regions.items():
            print(f"profile{label} region: {key} {ms:10.3f} ms device "
                  f"{n:6d}x {100 * ms / busy_ms:5.1f}% of busy", flush=True)


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
    """The path launched ``kernel`` once per layer and dispatch and no other
    ragged kernel.  Returns its count."""
    counts = ragged_counts(ragged_mod)
    check(counts[kernel] == eng.ragged_dispatches * SERVE_LAYERS,
          f"{label}: {kernel} launched {counts[kernel]} times, not "
          f"{eng.ragged_dispatches} dispatches x {SERVE_LAYERS}")
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


PLAIN_REQS, PLAIN_MAX_PROMPT = 4, 400


def plain_comparison(model, reqs, owner, name, plain, margin, **engine_kw):
    """A serve through the kernel path against the same engine with the
    kernel ``owner.name`` swapped for ``plain``, over the first
    ``PLAIN_REQS`` requests with prompts of at most ``PLAIN_MAX_PROMPT``
    tokens (the plain versions walk the blocks in Python: the whole
    traffic took 114 s through B2's).  Greedy streams must be equal but
    from a first divergence at a near tie under ``margin`` of the plain
    engine's own logits (``stream_divergences``).  Returns (the requests,
    greedy streams equal, divergences, their margins, seeded streams
    equal, kernel wall, plain wall)."""
    from paddle_tpu_torch.serving import Engine
    sub = [r for r in reqs if len(r[0]) <= PLAIN_MAX_PROMPT][:PLAIN_REQS]
    _, outs, wall = serve(model, sub, Engine, **engine_kw)
    real = getattr(owner, name)
    setattr(owner, name, plain)
    try:
        _, outs_p, wall_p, margins = serve_recording_margins(model, sub,
                                                             **engine_kw)
    finally:
        setattr(owner, name, real)
    near, gaps = stream_divergences(model, sub, outs, outs_p, margins,
                                    margin)
    same = sum(a.tolist() == b.tolist()
               for (_, kw), a, b in zip(sub, outs, outs_p) if not kw)
    seeded = all(a.tolist() == b.tolist()
                 for (_, kw), a, b in zip(sub, outs, outs_p) if kw)
    return sub, same, near, gaps, seeded, wall, wall_p


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

    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 num_layers=SERVE_LAYERS)
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(model, reqs, Engine, weight_dtype="int8")
    launches = check_launches(ragged_mod, eng, "ragged_paged_attention",
                              "weight-only int8 slice")
    n_int8 = sum(isinstance(m, WeightOnlyInt8Linear)
                 for m in model.modules())
    check(n_int8 == 4 * SERVE_LAYERS, f"{n_int8} int8 Linears, not "
          f"{4 * SERVE_LAYERS}")
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
    """Phase 10: int8 KV + int8 weights at full width.  Returns
    (the relayouted model, its streams, B2's launches)."""
    import torch
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.serving.quant import QuantKV

    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 num_layers=SERVE_LAYERS)
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(model, reqs, Engine, kv_dtype="int8",
                            weight_dtype="int8")
    launches = check_launches(ragged_mod, eng, "ragged_paged_attention_int8",
                              "int8 KV + weights slice")
    check(len(eng.k_pools) == SERVE_LAYERS
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
    def plain(q, k, v, tables, pos, width, k_scale, v_scale, *,
              block_size):
        return ragged_mod.ragged_paged_attention_ref(
            q, k, v, tables, pos, width, block_size=block_size,
            k_scale=k_scale, v_scale=v_scale)

    sub, same, near, gaps, seeded, wall3, wall4 = plain_comparison(
        model, reqs, ragged_mod, "ragged_paged_attention_int8", plain,
        1e-3, kv_dtype="int8")
    print(f"int8 slice: seeded streams repeat on a second engine (wall_s "
          f"{wall2:.3f}); over the {len(sub)} requests with prompts <= "
          f"{PLAIN_MAX_PROMPT} tokens ({[len(p) for p, _ in sub]}) greedy "
          f"streams equal to B2's plain version {same} of "
          f"{sum(1 for _, kw in sub if not kw)}, near-tie divergences (int8 "
          f"margin < 1e-3) {near} at margins {gaps}, seeded equal {seeded} "
          f"(kernel wall_s {wall3:.3f}, plain-version wall_s {wall4:.3f})",
          flush=True)
    profile_phase(model, reqs, Engine, card, label=" int8",
                  kv_dtype="int8")
    del eng, eng2
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
    group on one card, four over four cards), one a layer a dispatch, and
    no other ragged kernel.  Returns B4's count."""
    groups = len(ragged_mod.card_groups(eng.mesh))
    counts = ragged_counts(ragged_mod)
    want = eng.ragged_dispatches * SERVE_LAYERS * groups
    path = (kernel, "sharded_ragged_paged_attention")
    for name in path:
        check(counts[name] == want,
              f"{label}: {name} launched {counts[name]} times, not "
              f"{eng.ragged_dispatches} dispatches x {SERVE_LAYERS} x "
              f"{groups} card groups")
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
    again = profile_phase(tp, reqs, Engine, card, label=" mesh", ops=True,
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
    forward, B4 launched once per layer and dispatch for each card group (one
    group on one card, four over four cards), seeded streams equal.
    Prints each card's peak memory."""
    import torch
    from paddle_tpu_torch.distributed import serving_mesh
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    check(torch.cuda.device_count() >= 4, "--cards 4 needs four cards, "
          f"found {torch.cuda.device_count()}")
    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 num_layers=SERVE_LAYERS)
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
DEPTH_ROUNDS = (1, 2)              # async_depth of each A/B serve, in turn
PROFILE_DEPTHS = (1,)              # and of each profiled window after them
                                   # (phase 4's window is depth 2's)


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
    dense forward's argmax; B1 launched once per layer and dispatch.  Then a
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
    prompt lookup, depth 2, B1 launched once per layer and dispatch; greedy
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
    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 num_layers=SERVE_LAYERS)
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
    and a ``profile_phase`` window of (a).  Returns (B1's launches in
    (c), each serve's streams by tag: phase 22 (a)'s references)."""
    b1 = 0
    by_tag = {}
    for tag, name, kw in XLA_SERVES:
        eng, outs, launches = xla_serve(card, ragged_mod, fa, model, reqs,
                                        fp_outs, tag, name, kw)
        b1 += launches
        by_tag[tag] = outs
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
    profile_phase(model, reqs, Engine, card, label=" xla",
                  breakdown=True, **XLA_DEFAULT)
    check(not any(ragged_counts(ragged_mod).values()),
          "phase 16 (a): the XLA path launched a ragged kernel")
    return b1, by_tag


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
    m = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                             num_layers=SERVE_LAYERS)
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
    4's (near ties excepted), B1 launched once per layer and dispatch.  Then the
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
    "a" while its requests pin it is refused; B1 launched once per layer
    and dispatch.  The same 12 requests at ``attn_impl="xla"``: streams equal
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


def offload_serve(card, ragged_mod, model, label, kernel, mesh=False,
                  **kw):
    """Phase 17 (d), one pool form: a 96-block pool, a 2048 MiB host tier,
    three waves (``OFFLOAD_WAVES``: the first wave's prompts cached, the
    second's evicting them, the first wave again restored from host RAM).
    Restored streams equal a ``prefix_cache=False`` engine's except where
    its own top-2 margin is under ``margin`` (fp32 1e-4, int8 1e-3: phase
    10's rule); demotes, promotes and restored tokens all > 0; the path's
    kernel launched once per layer and dispatch.  With ``mesh`` (phase 22 (c)) the
    engines serve on phase 14's (2, 2) mesh at ``max_seq_len=512`` (the
    96 blocks split over two dp shards must each hold a max-length
    request), the kernel launched through B4, and a profiled window of
    the first wave served once more follows.  Returns its launches (B4's
    with ``mesh``)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import Engine
    V = model.embeddings.word_embeddings.weight.shape[0]
    rng = np.random.RandomState(2024)
    waves = [[(rng.randint(0, V, n).astype(np.int32), {}) for n in lens]
             for lens in OFFLOAD_WAVES]
    waves.append(waves[0])
    zero_ragged_counts(ragged_mod)
    geo = dict(max_seq_len=512) if mesh else {}
    eng = Engine(model, **dict(dict(max_seq_len=1024, kv_block_size=16,
                                    prefill_chunk=64, **OFFLOAD_KW), **geo),
                 **(dict(mesh=one_card_mesh()) if mesh else {}), **kw)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves:
        handles = [eng.submit(p, max_new_tokens=32) for p, _ in wave]
        eng.run_until_idle()
        outs.append([h.result(timeout=1) for h in handles])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (check_mesh_launches if mesh else check_launches)(
        ragged_mod, eng, kernel, f"offload {label}")
    reg = eng.registry
    demotes = reg.get("serving.offload_demotes").value
    promotes = reg.get("serving.offload_promotes").value
    hit = reg.get("serving.offload_hit_tokens").value
    check(demotes > 0 and promotes > 0 and hit > 0,
          f"offload {label}: demotes {demotes} promotes {promotes} "
          f"hit tokens {hit}")
    margin = 1e-3 if "kv_dtype" in kw else 1e-4
    _, ref, _, margins = serve_recording_margins(
        model, waves[0], mesh=mesh, prefix_cache=False, num_slots=4,
        **geo, **kw)
    near, gaps = stream_divergences(model, waves[0], outs[2], ref, margins,
                                    margin)
    exact = sum(a.tolist() == b.tolist() for a, b in zip(outs[2], ref))
    same_as_first = sum(a.tolist() == b.tolist()
                        for a, b in zip(outs[2], outs[0]))
    slice_line(
        f"gpt2-medium fp32 phase {'22 (c)' if mesh else '17 (d)'} offload "
        f"{label}", eng, wall,
        launches, card,
        f" offload_demotes {demotes:.0f} offload_promotes {promotes:.0f} "
        f"offload_hit_tokens {hit:.0f} kv_host_blocks "
        f"{reg.get('serving.kv_host_blocks').value:.0f} kv_host_bytes "
        f"{reg.get('serving.kv_host_bytes').value:.0f} "
        f"restored_equal_to_no_cache {exact}/4 (near-tie divergences "
        f"{near} at margins {gaps}) restored_equal_to_first_wave "
        f"{same_as_first}/4")
    if mesh:
        # the second wave once more (its blocks now on the device or the
        # host), a window of it profiled; its launches count too
        for p, _ in waves[1]:
            eng.submit(p, max_new_tokens=32)
        zero_ragged_counts(ragged_mod)
        d0 = eng.ragged_dispatches
        profile_window(eng, PROFILE_TICKS[1], card, f" {label}")
        eng.run_until_idle()
        n = ragged_counts(ragged_mod)["sharded_ragged_paged_attention"]
        check(n == (eng.ragged_dispatches - d0) * SERVE_LAYERS,
              f"offload {label}: B4 launched {n} times in the profiled wave, "
              f"not {eng.ragged_dispatches - d0} dispatches x {SERVE_LAYERS}")
        launches += n
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


def migrate_pair(model, reqs, ref_outs, recording=False, b_model=None,
                 b_kw=None, profile=None, **engine_kw):
    """Phase 18 (a), one pool form: every request of the traffic served
    on engine A, exported once it has ``MIGRATE_AFTER`` tokens (the
    demands registered at submit, ``deliver="return"``), imported by
    engine B (over ``b_model``, its keywords updated by ``b_kw``: phase
    22 (d) moves streams between a mesh and one device), every other
    payload through its JSON wire form, and decoded to the end there;
    ``profile`` = (card, label) profiles B's first ticks after the
    imports (``profile_window``).  Returns (A, B, payloads, streams, wall,
    margins of B when ``recording``)."""
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
        b = cls(model if b_model is None else b_model,
                **dict(ekw, **(b_kw or {})))
        ins = [b.migrate_in(payload_to_json(pl) if i % 2 else pl,
                            wait=False)
               for i, pl in enumerate(payloads)]
        if profile is not None:
            profile_window(b, PROFILE_TICKS[1], *profile)
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
    check(b1 == (a.ragged_dispatches + b.ragged_dispatches) * SERVE_LAYERS,
          f"phase 18 (a): B1 launched {b1} times, not (A {a.ragged_dispatches}"
          f" + B {b.ragged_dispatches}) dispatches x {SERVE_LAYERS}")
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
    check(b1 == dispatches * SERVE_LAYERS,
          f"phase 18 (a): B1 launched {b1} times over the migration pair "
          f"and the warmed engine, not {dispatches} dispatches x "
          f"{SERVE_LAYERS}")
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
    check(b2 == (a.ragged_dispatches + b.ragged_dispatches) * SERVE_LAYERS
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
                        # the clients' 600 s per attempt: the 60 s
                        # default races the routed serve's wall (about a
                        # minute for 12 concurrent migrations on the
                        # host's JSON), and a timed-out export fails over
                        # to an unmigrated serve
                        policy=RouterPolicy(disaggregate=True, seed=0,
                                            request_timeout_s=600),
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
    check(b1 == dispatches * SERVE_LAYERS,
          f"phase 18 (b): B1 launched {b1} times, not {dispatches} "
          f"dispatches x {SERVE_LAYERS}")
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
    check(b1 == dispatches * SERVE_LAYERS,
          f"phase 18 (c): B1 launched {b1} times, not {dispatches} "
          f"dispatches x {SERVE_LAYERS}")
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
    check(b1 == dispatches * SERVE_LAYERS,
          f"phase 18 (c): B1 launched {b1} times, not {dispatches} "
          f"dispatches x {SERVE_LAYERS}")
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
                             log_dir=FLEET_DIR, ready_timeout_s=300.0,
                             extra_args=("--num-layers",
                                         str(SERVE_LAYERS))) as fleet:
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
    "slice_fp16": (4, 16, 2048, 128, "float16", 0),
    "segments_fp16": (4, 16, 2048, 128, "float16", 4),
    # phase 21's per-rank shapes: dp2 x mp2 (8 heads a rank), and a data
    # or sharding rank of B=4 over 4 (and a pipeline micro-batch)
    "mesh_mp_bf16": (2, 8, 2048, 128, "bfloat16", 0),
    "mesh_row_bf16": (1, 16, 2048, 128, "bfloat16", 0),
}
# the cases phase 5 times (kernels, plain versions, SDPA, bounds)
FLASH_TIMED = ("slice_bf16", "slice_fp16")


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
    on the built libraries; every instantiation (element type, head dim)
    apart, demangled where ``c++filt`` exists.  None when no cuobjdump
    exists."""
    exe = cuobjdump()
    if exe is None:
        return None
    filt = shutil.which("c++filt")
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
                if filt:
                    fn = subprocess.run([filt, fn], capture_output=True,
                                        text=True).stdout.strip() or fn
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
    slice's shape in bf16 and fp16, times and bounds.  Returns {(kernel,
    dtype): result} for the ``FLASH_TIMED`` cases."""
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
        if case not in FLASH_TIMED:
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
              f"{dtype} forward {sdpa_fwd:.4f} ms, backward (dq, dk, dv in "
              f"one autograd call) {sdpa_bwd:.4f} ms, forward+backward "
              f"{sdpa_fwd + sdpa_bwd:.4f} ms", flush=True)
        # SDPA's backward gives dq, dk and dv in one call: it is the
        # yardstick of the two backward kernels together
        tag = "" if dtype == "bfloat16" else "_fp16"
        library = {"fwd": (sdpa_fwd, [f"flash_fwd{tag}"]),
                   "bwd_dkv": (sdpa_bwd, [f"flash_bwd_dkv{tag}",
                                          f"flash_bwd_dq{tag}"]),
                   "bwd_dq": (sdpa_bwd, [f"flash_bwd_dkv{tag}",
                                         f"flash_bwd_dq{tag}"])}
        for kernel in FLASH_KERNELS:
            ms = cuda_time_ms(kernel_fns[kernel], iters=10, warmup=2)
            plain_ms = cuda_time_ms(plain_fns[kernel], iters=3, warmup=1)
            bound, bound_by = flash_bound_ms(kernel, q)
            results[kernel, dtype] = dict(
                max_abs_err=errs[kernel], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by,
                library_ms=library[kernel][0],
                library_covers=library[kernel][1])
            print(f"kernel flash_{kernel} {dtype}: max_abs_err "
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
    train_profile(step, [x, y], card)
    del step, opt, model
    torch.cuda.empty_cache()
    return launches, tokens / wall


def train_profile(step, batch, card, label="train"):
    """One more step under torch.profiler: device time by kernel and the
    device's busy share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"{label} profile: one step wall_s {wall:.3f} device_busy_s "
          f"{busy_ms / 1e3:.3f} busy_share {busy_ms / 1e3 / wall:.3f} "
          f"[{card}]", flush=True)
    dev.sort(key=lambda e: -e.self_device_time_total)
    for e in dev[:12]:
        print(f"{label} profile kernel: "
              f"{e.self_device_time_total / 1e3:10.3f}"
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


# -- phase 19 -------------------------------------------------------------
RECIPE_TIMED = 3                   # (a): steps after the warm-up step
RECIPE_DOCS = (3, 6)               # documents a packed row, inclusive
O2_STEPS = 2                       # (b): steps after the warm-up step
RECIPE_GEN_PROMPT, RECIPE_GEN_NEW = 64, 16   # (d)


def packed_lm(model):
    """``model`` behind the positional signature ``TrainStep`` calls,
    ``(ids, labels, doc_lens)``, as a JAX pretraining script wraps it."""
    import torch

    class PackedLM(torch.nn.Module):
        def __init__(self, lm):
            super().__init__()
            self.lm = lm

        def forward(self, ids, labels, doc_lens):
            return self.lm(ids, labels=labels, doc_lens=doc_lens)

    return PackedLM(model)


def packed_batch(vocab, batch, seq, seed):
    """Ids and shifted labels ``[batch, seq]`` on the card, and int32
    ``doc_lens [batch, 6]`` on the host: each row packs 3-6 documents of
    uneven lengths; the last row stops seq/32 to seq/4 tokens short
    (padding: 64-511 at S=2048)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq + 1))
    doc_lens = np.zeros((batch, RECIPE_DOCS[1]), np.int32)
    for b in range(batch):
        n = rng.randint(RECIPE_DOCS[0], RECIPE_DOCS[1] + 1)
        total = seq if b < batch - 1 else seq - rng.randint(seq // 32,
                                                            seq // 4)
        cuts = np.sort(rng.choice(np.arange(16, total - 16), n - 1,
                                  replace=False))
        doc_lens[b, :n] = np.diff(np.concatenate([[0], cuts, [total]]))
    ids = torch.tensor(ids.astype(np.int64), device="cuda")
    return ids[:, :-1], ids[:, 1:], doc_lens


def recipe_schedule():
    from paddle_tpu_torch.optimizer import lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=100),
                           warmup_steps=3, start_lr=0.0, end_lr=1e-4)


def check_losses(losses, V, E, label):
    import math
    expect0 = math.log(V) + E * 0.02 ** 2 / 2
    check(all(math.isfinite(l) for l in losses),
          f"{label}: non-finite loss {losses}")
    check(abs(losses[0] - expect0) < 0.1,
          f"{label}: step-0 loss {losses[0]:.4f} is not within 0.1 of "
          f"ln V + E * 0.02^2 / 2 = {expect0:.4f}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall: "
          f"{losses}")
    return expect0


def recipe_phase(card, fa, phase6_tps):
    """Phase 19: the GPT pretraining recipe at full width and depth
    ((a), (b)), its kernel and plain paths ((c)) and ``generate`` on the
    scan model ((d)).  Returns (a)'s flash launches by kernel."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel import TrainStep

    # (a) fp32 weights, O1, AdamW over warmup + cosine with a global-norm
    # clip, recompute, packed documents
    model = GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.1,
                                 fused_loss=True, use_recompute=True)
    check(len(model.blocks) == N_LAYERS, "gpt3-1.3b has 24 layers")
    E = model.blocks[0].attn.hidden_size
    V = model.head.lm_head.weight.shape[0]
    sched = recipe_schedule()
    opt = AdamW(learning_rate=sched, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0),
                parameters=model.parameters())
    step = TrainStep(packed_lm(model), opt, amp_level="O1")
    x, y, dl = packed_batch(V, TRAIN_B, TRAIN_S, seed=0)
    batch = [x, y, dl]
    ref = recipe_schedule()
    want_lr = []
    for _ in range(RECIPE_TIMED + 1):
        want_lr.append(ref())
        ref.step()
    zero_flash_counts(fa)
    scalar0 = fa.ROUTE_LAUNCHES["scalar"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, used = [], []

    def one_step():
        losses.append(step.step(batch))
        used.append(opt.last_step_lr)
        sched.step()

    t_warm = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm_s = t0 - t_warm
    for _ in range(RECIPE_TIMED):
        one_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts(fa)
    peak_rc = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    steps = RECIPE_TIMED + 1
    check(launches == {"fwd": 2 * N_LAYERS * steps,
                       "bwd_dkv": N_LAYERS * steps,
                       "bwd_dq": N_LAYERS * steps},
          f"recipe: flash launches {launches} in {steps} steps, not "
          f"{2 * N_LAYERS} forwards (recompute) and {N_LAYERS} of each "
          "backward a step")
    check(fa.ROUTE_LAUNCHES["scalar"] == scalar0,
          "recipe: a flash launch took the scalar fp32 route under O1")
    check(used == want_lr, f"recipe: learning rates {used} are not the "
          f"scheduler's {want_lr}")
    expect0 = check_losses(losses, V, E, "recipe (a)")
    tokens = TRAIN_B * TRAIN_S * RECIPE_TIMED
    kept = int((dl.sum(axis=1) - (dl > 0).sum(axis=1)).sum()) * RECIPE_TIMED
    tps = tokens / wall
    print(f"phase 19 (a) recipe gpt3-1.3b fp32 O1 recompute packed: B "
          f"{TRAIN_B} S {TRAIN_S} docs/row "
          f"{[int((r > 0).sum()) for r in dl]} padding "
          f"{TRAIN_B * TRAIN_S - int(dl.sum())} losses "
          + " ".join(f"{l:.4f}" for l in losses)
          + f" (step-0 expected {expect0:.4f}) lr "
          + " ".join(f"{v:.3e}" for v in used)
          + f" warmup_s {warm_s:.3f} timed_steps {RECIPE_TIMED} wall_s "
          f"{wall:.3f} s_per_step {wall / RECIPE_TIMED:.4f} tokens_per_s "
          f"{tps:.1f} (x phase 6 {tps / phase6_tps:.3f}) "
          f"scored_tokens_per_s {kept / wall:.1f} peak_mem_gb "
          f"{peak_rc:.2f} flash_launches {launches} [{card}]", flush=True)
    train_profile(step, batch, card, label="recipe")
    for blk in model.blocks:
        blk.use_recompute = False
    zero_flash_counts(fa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step.step(batch)
    torch.cuda.synchronize()
    peak_full = torch.cuda.max_memory_allocated() / 1e9
    check(flash_counts(fa)["fwd"] == N_LAYERS,
          "recipe without recompute: not one flash forward a layer")
    check(peak_rc < peak_full,
          f"recipe: peak with recompute {peak_rc:.2f} GB is not below "
          f"the peak without it {peak_full:.2f} GB")
    print(f"phase 19 (a) peak memory: recompute {peak_rc:.2f} GB, without "
          f"recompute {peak_full:.2f} GB (one step) [{card}]", flush=True)
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) O2 (bf16 weights, strategy.amp with use_pure_fp16), scan_layers,
    # bf16 moments
    import types
    model = GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.1,
                                 fused_loss=True, scan_layers=True)
    amp.decorate(model, level="O2")
    check(model.blocks.attn.qkv_proj.weight.dtype == torch.bfloat16
          and model.blocks.attn.qkv_proj.weight.shape[0] == N_LAYERS,
          "O2 scan model: bf16 stacked weights")
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                multi_precision=False, parameters=model.parameters())
    strategy = types.SimpleNamespace(amp=True,
                                     amp_configs={"use_pure_fp16": True})
    step = TrainStep(packed_lm(model), opt, strategy=strategy)
    check(step.amp_level == "O2", "strategy.amp use_pure_fp16 is O2")
    zero_flash_counts(fa)
    scalar0 = fa.ROUTE_LAUNCHES["scalar"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step.step(batch)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(O2_STEPS):
        losses.append(step.step(batch))
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    losses = [float(l) for l in losses]
    check_losses(losses, V, E, "recipe (b) O2 scan")
    moments = {st["moment1"].dtype for st in opt.state.values()} | {
        st["moment2"].dtype for st in opt.state.values()}
    check(moments == {torch.bfloat16} and len(opt.state) == len(
        list(model.parameters())), f"O2: moments {moments}, not bf16")
    counts_b = flash_counts(fa)
    scalar_b = fa.ROUTE_LAUNCHES["scalar"] - scalar0
    check(counts_b["fwd"] == N_LAYERS * (O2_STEPS + 1),
          f"O2 scan: flash launches {counts_b}")
    print(f"phase 19 (b) gpt3-1.3b O2 bf16 weights scan_layers "
          f"multi_precision=False packed: losses "
          + " ".join(f"{l:.4f}" for l in losses)
          + f" s_per_step {wall_b / O2_STEPS:.4f} tokens_per_s "
          f"{TRAIN_B * TRAIN_S * O2_STEPS / wall_b:.1f} peak_mem_gb "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} moments "
          f"{sorted(str(m) for m in moments)} flash_launches {counts_b} "
          f"(scalar fp32 route {scalar_b}: O2 runs attention in f32, as "
          f"the JAX package's O2 promotes it) [{card}]", flush=True)
    del step, opt

    # (d) generate on the scan model against an unrolled copy
    import numpy as np
    un = GPTModel.from_config("gpt3-1.3b", seed=1, dropout=0.0,
                              fused_loss=True).to(torch.bfloat16)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for n, p in un.named_parameters():
            m = re.fullmatch(r"blocks\.(\d+)\.(.+)", n)
            p.copy_(src[f"blocks.{m.group(2)}"][int(m.group(1))] if m
                    else src[n])
    prompts = np.random.RandomState(7).randint(0, V, (2, RECIPE_GEN_PROMPT))
    t0 = time.perf_counter()
    got = model.generate(prompts, max_new_tokens=RECIPE_GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    want = un.generate(prompts, max_new_tokens=RECIPE_GEN_NEW)
    check(torch.equal(got, want),
          "generate on the scan model differs from its unrolled copy's")
    print(f"phase 19 (d) generate on the O2 scan model (after (b)'s "
          f"steps): 2 prompts of {RECIPE_GEN_PROMPT}, {RECIPE_GEN_NEW} "
          f"greedy tokens equal the unrolled copy's; wall_s {gen_s:.3f} "
          f"[{card}]", flush=True)
    del model, un, src
    gc.collect()
    torch.cuda.empty_cache()

    recipe_compare_phase(fa, card)
    return launches


def recipe_compare_phase(fa, card):
    """Phase 19 (c): phase 7's comparison on the recipe's path — 2 layers
    of gpt3-1.3b in fp32 under O1 with recompute and packed rows, B=1,
    S=2048, through the kernels and through the plain versions."""
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.nn.functional import attention as attn_mod

    model = GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.0,
                                 fused_loss=True, num_layers=2,
                                 use_recompute=True)
    V = model.head.lm_head.weight.shape[0]
    x, y, dl = packed_batch(V, 2, TRAIN_S, seed=3)
    x, y, dl = x[1:], y[1:], dl[1:]          # the row with padding

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        with amp.auto_cast(level="O1"):
            loss = model(x, labels=y, doc_lens=dl)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone()
                                      for n, p in model.named_parameters()}

    before = flash_counts(fa)
    l_kernel, g_kernel = loss_and_grads()
    after = flash_counts(fa)
    check(after["fwd"] - before["fwd"] == 4
          and after["bwd_dkv"] - before["bwd_dkv"] == 2
          and after["bwd_dq"] - before["bwd_dq"] == 2,
          f"recipe kernel path: flash launches {before} -> {after}, not 2 "
          "forwards and 1 of each backward a layer")
    real = attn_mod.flash_attention
    attn_mod.flash_attention = fa.flash_attention_ref
    try:
        l_plain, g_plain = loss_and_grads()
    finally:
        attn_mod.flash_attention = real
    check(abs(l_kernel - l_plain) <= 1e-3 * abs(l_plain),
          f"recipe: loss through the kernels {l_kernel} vs plain {l_plain}")
    worst = 0.0
    for n, gp in g_plain.items():
        rel = float((g_kernel[n] - gp).norm() / gp.norm().clamp(min=1e-30))
        check(rel <= 2e-2, f"recipe gradient {n}: relative L2 error "
              f"{rel:.3e}")
        worst = max(worst, rel)
    print(f"phase 19 (c) recipe kernel vs plain (gpt3-1.3b width, 2 "
          f"layers, fp32 weights, O1, recompute, {int((dl > 0).sum())} "
          f"packed documents, B=1, S={TRAIN_S}): loss {l_kernel:.6f} vs "
          f"{l_plain:.6f}, worst gradient relative L2 error {worst:.3e} "
          f"over {len(g_plain)} parameters (tolerance loss rtol 1e-3, "
          f"gradients 2e-2) [{card}]", flush=True)
    del model
    torch.cuda.empty_cache()


# -- phase 20 -------------------------------------------------------------
MOE_CFG = dict(moe_experts=8, moe_every=2)   # MoELayer defaults: k 2, cf 2
MOE_TRAIN_B, MOE_TRAIN_S, MOE_TIMED = 8, 1024, 3
BERT_B, BERT_S, BERT_TIMED, BERT_LR = 32, 128, 3, 2e-5
SP_SHAPE = (2, 1024, 16, 64)       # gpt2-medium's attention, B=2
SP_DEGREE = 4
SP_TOL = (2e-5, 1e-4)              # f32: atol of the output, of dq/dk/dv


def moe_aux(model):
    from paddle_tpu_torch.distributed import collect_moe_aux_loss
    aux = collect_moe_aux_loss(model)
    return float(aux.detach())


def moe_serve_phase(card, ragged_mod, reqs, fp_tps):
    """Phase 20 (a): an MoE gpt2-medium (every second block 8 experts)
    serves phase 4's traffic with phase 4's engine; returns (the model,
    B1's launches)."""
    import torch
    from paddle_tpu_torch.distributed import MoELayer
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.models import gpt as gpt_mod
    from paddle_tpu_torch.serving import Engine

    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 num_layers=SERVE_LAYERS, **MOE_CFG)
    n_moe = sum(isinstance(b.mlp, MoELayer) for b in model.blocks)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_moe == SERVE_LAYERS // 2,
          f"{n_moe} MoE blocks, not {SERVE_LAYERS // 2}")
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(model, reqs, Engine)
    launches = check_launches(ragged_mod, eng, "ragged_paged_attention",
                              "phase 20 (a) MoE serve")
    for (p, _), ids in zip(reqs, outs):
        check(len(ids) == len(p) + 32, "a stream is not 32 tokens long")
    eng2, outs2, wall2 = serve(model, reqs, Engine)
    check(all(a.tolist() == b.tolist() for a, b in zip(outs, outs2)),
          "phase 20 (a): the MoE streams did not repeat on a second run")
    slice_line(f"gpt2-medium MoE {MOE_CFG} fp32 phase 20 (a)", eng, wall,
               launches, card, f" params {n_params} moe_blocks {n_moe} "
               f"repeat_wall_s {wall2:.3f} (phase 4 tokens_per_s "
               f"{fp_tps:.2f})")
    # the kernel path against B1's plain version over the same (shorter)
    # traffic: capacity makes the rows of a window interact, so the two
    # must see the same windows
    def plain(q, k, v, tables, pos, width, *, block_size, k_scale=None,
              v_scale=None, variant="stream"):
        return ragged_mod.ragged_paged_attention_ref(
            q, k, v, tables, pos, width, block_size=block_size,
            k_scale=k_scale, v_scale=v_scale)

    sub, same, near, gaps, seeded, wall3, wall4 = plain_comparison(
        model, reqs, gpt_mod, "ragged_paged_attention", plain, 1e-4)
    print(f"phase 20 (a) MoE kernel vs plain B1 path ({len(sub)} requests "
          f"with prompts <= {PLAIN_MAX_PROMPT} tokens, prompts "
          f"{[len(p) for p, _ in sub]}): greedy streams equal {same} of "
          f"{sum(1 for _, kw in sub if not kw)}, near-tie divergences "
          f"(margin < 1e-4) {near} at margins {gaps}, seeded equal "
          f"{seeded}; kernel wall_s {wall3:.3f}, plain wall_s {wall4:.3f} "
          f"[{card}]",
          flush=True)
    profile_phase(model, reqs, Engine, card, label=" moe")
    share, kpt = PROFILES[" moe"]
    share4, kpt4 = PROFILES.get("", (float("nan"), float("nan")))
    print(f"phase 20 (a) MoE serve: tokens_per_s "
          f"{eng.tokens_generated / wall:.2f} kernels_per_tick {kpt:.1f} "
          f"busy_share {share:.3f}; phase 4: tokens_per_s {fp_tps:.2f} "
          f"kernels_per_tick {kpt4:.1f} busy_share {share4:.3f} [{card}]",
          flush=True)
    del eng, eng2
    return model, launches


def moe_train_phase(card, fa, model):
    """Phase 20 (b): the MoE gpt2-medium trained at B=8, S=1024 (AdamW,
    recompute, fused head + CE): losses finite and falling, the first
    within 0.1 of ln V + E * 0.02^2 / 2 once its aux loss is taken
    off."""
    import math
    import torch
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    model.fused_loss = True
    for blk in model.blocks:
        blk.use_recompute = True
    model.train()
    E = model.blocks[0].attn.hidden_size
    V = model.head.lm_head.weight.shape[0]
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, opt)
    x, y = train_batch(V, MOE_TRAIN_B, MOE_TRAIN_S, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(fa)
    losses = [step.step([x, y])]
    aux0 = moe_aux(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE_TIMED):
        losses.append(step.step([x, y]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    aux_last = moe_aux(model)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(l) for l in losses]
    check(all(math.isfinite(l) for l in losses),
          f"phase 20 (b): non-finite loss {losses}")
    expect0 = math.log(V) + E * 0.02 ** 2 / 2
    check(abs(losses[0] - aux0 - expect0) < 0.1,
          f"phase 20 (b): step-0 CE {losses[0] - aux0:.4f} (loss "
          f"{losses[0]:.4f} - aux {aux0:.4f}) is not within 0.1 of "
          f"{expect0:.4f}")
    check(losses[-1] < losses[0], f"phase 20 (b): the loss did not fall: "
          f"{losses}")
    check(sum(flash_counts(fa).values()) == 0,
          "phase 20 (b): S=1024 launched a flash kernel")
    tokens = MOE_TRAIN_B * MOE_TRAIN_S * MOE_TIMED
    print(f"phase 20 (b) train gpt2-medium MoE {MOE_CFG} fp32 recompute: "
          f"B {MOE_TRAIN_B} S {MOE_TRAIN_S} losses "
          + " ".join(f"{l:.4f}" for l in losses)
          + f" (aux in them: step 0 {aux0:.4f}, last {aux_last:.4f}; step-0 "
          f"CE expected {expect0:.4f}) timed_steps {MOE_TIMED} wall_s "
          f"{wall:.3f} s_per_step {wall / MOE_TIMED:.4f} tokens_per_s "
          f"{tokens / wall:.1f} peak_mem_gb {peak_gb:.2f} [{card}]",
          flush=True)
    del step, opt
    torch.cuda.empty_cache()


def bert_phase(card, fa, ragged_mod):
    """Phase 20 (c): BERT-base fine-tune (``BASELINE.md`` config 3) under
    ``TrainStep(amp_level="O1")``: losses finite and falling."""
    import math
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         BertModel)
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    torch.manual_seed(0)
    model = BertForSequenceClassification(
        BertModel.from_config("bert-base", seed=0), 2)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(0)
    lens = rng.randint(32, BERT_S + 1, BERT_B)
    ids = rng.randint(0, 30522, (BERT_B, BERT_S))
    mask = (np.arange(BERT_S)[None] < lens[:, None]).astype(np.int64)
    labels = rng.randint(0, 2, BERT_B)
    # a synthetic pair task: a row of class 1 is segment B throughout, so
    # the label rides the token types.  Labels independent of the inputs
    # leave a randomly initialized encoder's loss at ln 2: its rows'
    # pooled outputs start nearly equal, and 6 steps of AdamW only move
    # the shared logit back and forth
    types = np.repeat(labels[:, None], BERT_S, axis=1)
    batch = [torch.tensor(a, device="cuda") for a in (ids, types, mask)]
    y = torch.tensor(labels, device="cuda")
    # bench.py's BERT fine-tune rate
    opt = AdamW(learning_rate=BERT_LR, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, opt, loss_fn=cross_entropy, amp_level="O1")
    zero_flash_counts(fa)
    zero_ragged_counts(ragged_mod)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step.step(batch, [y])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BERT_TIMED):
        losses.append(step.step(batch, [y]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    RATES["bert"] = BERT_B * BERT_TIMED / wall
    losses = [float(l) for l in losses]
    check(all(math.isfinite(l) for l in losses),
          f"phase 20 (c): non-finite loss {losses}")
    check(losses[-1] < losses[0], f"phase 20 (c): the loss did not fall: "
          f"{losses}")
    kernels = sum(flash_counts(fa).values()) + sum(
        ragged_counts(ragged_mod).values())
    check(kernels == 0, f"phase 20 (c): BERT launched {kernels} "
          "attention kernels")
    print(f"phase 20 (c) BERT-base fine-tune O1: params {n_params} B "
          f"{BERT_B} S {BERT_S} mask lengths {int(lens.min())}-"
          f"{int(lens.max())} losses " + " ".join(f"{l:.4f}" for l in losses)
          + f" timed_steps {BERT_TIMED} wall_s {wall:.3f} s_per_step "
          f"{wall / BERT_TIMED:.4f} samples_per_s "
          f"{BERT_B * BERT_TIMED / wall:.1f} peak_mem_gb {peak_gb:.2f}; no "
          f"TPU kernel runs on this path (the JAX package computes BERT in "
          f"XLA; flash and ragged launches 0) [{card}]", flush=True)
    del step, opt, model
    torch.cuda.empty_cache()


def sp_phase(card, fa):
    """Phase 20 (d): ring and Ulysses attention over ``build_mesh(sp=4)``
    on one card against the dense reference; then two gpt2-medium training
    steps with ``use_sp="ring"`` on the degenerate one-card path."""
    import math
    import torch
    from paddle_tpu_torch.distributed import (build_mesh, get_mesh,
                                              ring_attention, set_mesh,
                                              ulysses_attention)
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.nn.functional.attention import \
        _reference_attention
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = build_mesh(sp=SP_DEGREE, devices=[dev] * SP_DEGREE)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(*SP_SHAPE, generator=gen, device="cuda")
                   for _ in range(4))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    want = run(lambda a, b, c: _reference_attention(a, b, c, None, None,
                                                    True))
    ms = {"reference": cuda_time_ms(lambda: run(
        lambda a, b, c: _reference_attention(a, b, c, None, None, True)),
        iters=5, warmup=1)}
    for name, fn in (("ring", ring_attention),
                     ("ulysses", ulysses_attention)):
        call = (lambda f: lambda a, b, c: f(a, b, c, causal=True,
                                            mesh=mesh))(fn)
        got = run(call)
        errs = []
        for part, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            tol = SP_TOL[0] if part == "o" else SP_TOL[1]
            check(bool(torch.isfinite(g).all()),
                  f"phase 20 (d) {name}: non-finite {part}")
            err = float((g - w).abs().max())
            check(err <= tol, f"phase 20 (d) {name}: {part} max_abs_err "
                  f"{err:.3e} over {tol}")
            errs.append(err)
        ms[name] = cuda_time_ms(lambda: run(call), iters=5, warmup=1)
        print(f"phase 20 (d) {name}_attention sp={SP_DEGREE} (4 ranks on "
              f"cuda:0) B,S,H,hd {SP_SHAPE} fp32 causal: max_abs_err o "
              f"{errs[0]:.3e} dq {errs[1]:.3e} dk {errs[2]:.3e} dv "
              f"{errs[3]:.3e} (tolerance {SP_TOL[0]} output, {SP_TOL[1]} "
              f"gradients) fwd+bwd ms {ms[name]:.3f} (dense reference "
              f"{ms['reference']:.3f}) [{card}]", flush=True)
    del q, k, v, do, want
    prev = get_mesh()
    set_mesh(None)
    try:
        model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.1,
                                     fused_loss=True, use_sp="ring")
        E = model.blocks[0].attn.hidden_size
        V = model.head.lm_head.weight.shape[0]
        step = TrainStep(model, AdamW(learning_rate=1e-4,
                                      parameters=model.parameters()))
        x, y = train_batch(V, 4, 1024, seed=0)
        zero_flash_counts(fa)
        t0 = time.perf_counter()
        losses = [float(step.step([x, y])) for _ in range(2)]
        wall = time.perf_counter() - t0
    finally:
        set_mesh(prev)
    check_losses(losses, V, E, "phase 20 (d) use_sp=ring")
    check(sum(flash_counts(fa).values()) == 0,
          "phase 20 (d): the degenerate ring launched a flash kernel")
    print(f"phase 20 (d) gpt2-medium use_sp='ring' (no sp mesh: the "
          f"degenerate single block, f32, dropout on the probabilities) B 4 "
          f"S 1024: losses {losses[0]:.4f} {losses[1]:.4f} wall_s "
          f"{wall:.3f} for 2 steps [{card}]", flush=True)
    del step, model
    torch.cuda.empty_cache()


def fp16_train_phase(card, fa):
    """Phase 20 (e): one gpt3-1.3b step (fp32 weights) at B=4, S=2048
    under ``auto_cast(dtype="float16")``: the flash kernels run in fp16
    (24 launches each), the loss is finite.  Returns the launches."""
    import math
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.1,
                                 fused_loss=True)
    V = model.head.lm_head.weight.shape[0]
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    x, y = train_batch(V, TRAIN_B, TRAIN_S, seed=0)
    zero_flash_counts(fa)
    halves = fa.DTYPE_LAUNCHES[torch.float16]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt.zero_grad(set_to_none=True)
    with amp.auto_cast(dtype="float16"):
        loss = model(x, labels=y)
    loss.backward()
    opt.apply_gradients()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts(fa)
    fp16 = fa.DTYPE_LAUNCHES[torch.float16] - halves
    finite = sum(bool(torch.isfinite(p.grad).all())
                 for p in model.parameters() if p.grad is not None)
    n_grads = sum(p.grad is not None for p in model.parameters())
    check(math.isfinite(float(loss)), f"phase 20 (e): loss {float(loss)}")
    for name, n in launches.items():
        check(n == N_LAYERS, f"phase 20 (e): flash {name} launched {n} "
              f"times, not {N_LAYERS}")
    check(fp16 == 3 * N_LAYERS, f"phase 20 (e): {fp16} fp16 launches, not "
          f"{3 * N_LAYERS}")
    check(finite == n_grads, f"phase 20 (e): {n_grads - finite} gradients "
          "not finite")
    print(f"phase 20 (e) gpt3-1.3b fp32 weights auto_cast(float16) B "
          f"{TRAIN_B} S {TRAIN_S}: loss {float(loss):.4f} flash_launches "
          f"{launches} (fp16 {fp16}) finite gradients {finite}/{n_grads} "
          f"step_s {wall:.3f} peak_mem_gb "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} [{card}]",
          flush=True)
    del opt, model, loss
    torch.cuda.empty_cache()
    return launches


def slice13_phase(card, fa, ragged_mod, reqs, fp_tps):
    """Phase 20 (a)-(e).  Returns (B1's launches, the fp16 flash
    launches)."""
    import torch
    t0 = time.perf_counter()
    zero_flash_counts(fa)
    model, b1 = moe_serve_phase(card, ragged_mod, reqs, fp_tps)
    check(sum(flash_counts(fa).values()) == 0,
          "phase 20 (a) launched a flash kernel")
    moe_train_phase(card, fa, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    bert_phase(card, fa, ragged_mod)
    sp_phase(card, fa)
    fp16 = fp16_train_phase(card, fa)
    print(f"phase 20 wall_s {time.perf_counter() - t0:.1f}", flush=True)
    return b1, fp16


# -- phase 21 -------------------------------------------------------------
MESH_TIMED = 2                     # steps after the warm-up step
MESH_REPEAT = 2                    # steps of the same-seed rerun
MESH_REPEATED = ("dp2_mp2", "pp4_1f1b")   # the runs rerun from the seed
MESH_GRAD_TOL, MESH_LOSS_RTOL = 2e-2, 1e-2
MESH_RUNS = ("dp2_sharding2_stage2", "sharding4_stage3", "dp2_mp2",
             "pp4_gpipe", "pp4_1f1b")
PIPE_B = 8                         # the pipelines' batch (phases 21, 23)
MP_SHAPE = (2, 2048, 8, 128)       # mesh 3's per-rank attention, bf16
# every run's mesh (a pipeline's by its name before the schedule) and a
# pipeline's micro-batches: pp4's one row a micro-batch, phase 23's two,
# which split over dp
MESH_SHAPES = {"dp2_sharding2_stage2": dict(dp=2, sharding=2),
               "sharding4_stage3": dict(sharding=4),
               "dp2_mp2": dict(dp=2, mp=2), "pp4": dict(pp=4),
               "dp2_pp2": dict(dp=2, pp=2), "mp2_pp2": dict(mp=2, pp=2)}
PIPE_MICRO = {"pp4": 8, "dp2_pp2": 4, "mp2_pp2": 4}
STORED_INPUTS = {}                 # 1F1B run -> its most inputs a stage
POST_NUMEL = {}                    # 1F1B run -> the elements of its post


def check_1f1b_memory(label, peaks, pipe):
    """1F1B's memory against GPipe's (with recompute) on the mesh
    ``pipe``: at most 2P - 1 < M stage inputs a stage between ticks
    (``max_stored_inputs``), and a peak at most GPipe's plus one gradient
    of ``post`` in bf16 and fp32 a running pipeline.  The last stage adds
    a micro-batch's gradient of ``post`` (the matmul's bf16 one and its
    fp32 cast) to the one accumulated so far, where GPipe's one backward
    over the batch makes its gradient the accumulated one; every other
    tensor 1F1B holds GPipe holds too (its M stage inputs a stage, one
    micro-batch's stage recomputed at a time).  Returns the line's
    text."""
    f1b, gpipe = pipe + "_1f1b", pipe + "_gpipe"
    M, P = PIPE_MICRO[pipe], MESH_SHAPES[pipe]["pp"]
    held = STORED_INPUTS[f1b]
    check(held == 2 * P - 1 < M,
          f"phase {label}: 1F1B held {held} stage inputs a stage between "
          f"ticks, not 2P - 1 = {2 * P - 1} (GPipe holds M = {M})")
    n = MESH_SHAPES[pipe].get("dp", 1)
    slack = POST_NUMEL[f1b] * (2 + 4) * n / 1e9
    check(peaks[f1b] <= peaks[gpipe] + slack,
          f"phase {label}: 1F1B's peak {peaks[f1b]:.2f} GB is over GPipe's "
          f"{peaks[gpipe]:.2f} GB plus {n} gradient(s) of post in bf16 and "
          f"fp32 ({slack:.2f} GB) at M={M}, P={P}")
    return (f"1F1B held at most {held} stage inputs a stage (GPipe {M}), "
            f"peak {peaks[f1b]:.2f} GB <= GPipe {peaks[gpipe]:.2f} + post's "
            f"gradient transient {slack:.2f} GB at M={M}")


def is_pipe(kind):
    return kind.endswith(("_gpipe", "_1f1b"))


def mesh_shape(kind):
    return MESH_SHAPES[kind.rsplit("_", 1)[0] if is_pipe(kind) else kind]


def tp_ends(pipe):
    """``pipe`` with its embedding and head swapped for their
    vocab-parallel forms (``use_mp=True``) on the same weights; the
    blocks stay dense."""
    import torch
    from paddle_tpu_torch.models.gpt import GPTEmbeddings, GPTLMHead
    pre, post = pipe.pre, pipe.post
    V, E = pre.word_embeddings.weight.shape
    S = pre.position_embeddings.weight.shape[0]
    with torch.device(post.ln_f.weight.device):
        tpre = GPTEmbeddings(V, E, S, 0.0, use_mp=True)
        tpost = GPTLMHead(E, V, use_mp=True)
    with torch.no_grad():
        tpre.word_embeddings.weight.copy_(pre.word_embeddings.weight)
        tpre.position_embeddings.weight.copy_(
            pre.position_embeddings.weight)
        tpost.ln_f.weight.copy_(post.ln_f.weight)
        tpost.ln_f.bias.copy_(post.ln_f.bias)
        tpost.lm_head.weight.copy_(post.lm_head.weight.t())
    pipe.pre, pipe.post = tpre, tpost
    return pipe


def mesh_model(kind, recompute=True):
    """gpt3-1.3b from seed 0 in fp32 at dropout 0, in the form ``kind``
    trains: the dense model with recompute and the fused head + CE (the
    reference and meshes 1-2), its tensor-parallel form (mesh 3), or
    ``gpt_pipe_model`` (the pipelines; the same weights from the same
    seed), over mp with a vocab-parallel embedding and head."""
    from paddle_tpu_torch.models import GPTModel, gpt_pipe_model
    if is_pipe(kind):
        pipe = gpt_pipe_model("gpt3-1.3b", dropout=0.0, seed=0)
        return tp_ends(pipe) if "mp" in mesh_shape(kind) else pipe
    model = GPTModel.from_config("gpt3-1.3b", seed=0, dropout=0.0,
                                 fused_loss=True, use_recompute=recompute)
    if kind == "dp2_mp2":
        tp = model.to_tensor_parallel()
        del model
        for blk in tp.blocks:
            blk.use_recompute = True
        return tp
    return model


def mesh_step(kind, model, opt):
    """The ``TrainStep`` of run ``kind``: every rank on this card."""
    import torch
    from paddle_tpu_torch.distributed import build_mesh
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    from paddle_tpu_torch.parallel import TrainStep
    shape = mesh_shape(kind)
    s = DistributedStrategy()
    if "stage" in kind:
        s.sharding = True
        s.sharding_configs["stage"] = int(kind[-1])
    loss_fn = None
    if is_pipe(kind):
        s.pipeline = True
        s.pipeline_configs.update(
            accumulate_steps=PIPE_MICRO[kind.rsplit("_", 1)[0]],
            schedule_mode="1F1B" if "1f1b" in kind else "F-then-B")
        s.recompute = "gpipe" in kind
        loss_fn = GPTPretrainingCriterion()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = build_mesh(devices=[dev] * 4, **shape)
    return TrainStep(model, opt, loss_fn=loss_fn, strategy=s, mesh=mesh,
                     amp_level="O1")


def dense_grad_name(kind, name, g):
    """``(name, gradient)`` of a run's parameter in the dense model's
    names and layouts: the pipeline's ``pre`` / ``post``, and the
    tensor-parallel form's relayouts undone (``to_tensor_parallel``,
    ``tp_ends``)."""
    if is_pipe(kind):
        name = re.sub(r"^post\.", "head.",
                      re.sub(r"^pre\.", "embeddings.", name))
        if "mp" in mesh_shape(kind) and name == "head.lm_head.weight":
            g = g.t()
        return name, g
    if kind != "dp2_mp2":
        return name, g
    E = g.shape[0]
    for tp, dense, fn in (
            ("attn.qkv_weight", "attn.qkv_proj.weight",
             lambda t: t.reshape(E, -1).t()),
            ("attn.qkv_bias", "attn.qkv_proj.bias", lambda t: t.reshape(-1)),
            ("attn.out_weight", "attn.out_proj.weight",
             lambda t: t.reshape(-1, t.shape[-1]).t()),
            ("attn.out_bias", "attn.out_proj.bias", lambda t: t),
            ("mlp.fc1.weight", "mlp.fc1.weight", lambda t: t.t()),
            ("mlp.fc2.weight", "mlp.fc2.weight", lambda t: t.t()),
            ("head.lm_head.weight", "head.lm_head.weight", lambda t: t.t())):
        if name.endswith(tp):
            return name[:-len(tp)] + dense, fn(g)
    return name, g


def mesh_state_gb(step):
    """(parameters + optimizer state of every rank, their gradients) in
    GB, each storage counted once (a rank that shares the model's
    storage adds nothing)."""
    eng = step.engine
    leaves = [t for lv in eng.leaves for t in lv.values()]
    states = [t for st in eng.opt_state for sub in st.values()
              for t in sub.values()]
    seen, total = set(), 0
    for t in leaves + states:
        ptr = t.untyped_storage().data_ptr()
        if ptr not in seen:
            seen.add(ptr)
            total += t.untyped_storage().nbytes()
    grads = sum(t.numel() * t.element_size() for t in leaves
                if t.requires_grad)
    return total / 1e9, grads / 1e9


def mesh_run(kind, batch, fa, card, ref=None, steps=1 + MESH_TIMED,
             profile=False, phase="21", recompute=True):
    """One run of ``kind`` (see ``mesh_train_phase``; a flat one's blocks
    without ``use_recompute`` when not ``recompute``).  Returns (losses,
    flash launches, peak GB, s a step, tokens/s)."""
    import math
    import torch
    from paddle_tpu_torch.optimizer import AdamW
    model = mesh_model(kind, recompute)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    step = mesh_step(kind, model, opt)
    state_gb, grads_gb = mesh_state_gb(step)
    x, y = batch
    pipe = is_pipe(kind)
    args = ([x], [y]) if pipe else ([x, y],)
    zero_flash_counts(fa)
    scalar0 = fa.ROUTE_LAUNCHES["scalar"]
    torch.cuda.synchronize()
    step.keep_grads = ref is not None
    t_warm = time.perf_counter()
    losses = [step.step(*args)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_warm
    worst = None
    if ref is not None:
        worst = (0.0, "")
        for name, g in step.full_grads(device="cpu").items():
            name, g = dense_grad_name(kind, name, g)
            want = ref[name]
            rel = float((g.float() - want).norm()
                        / want.norm().clamp(min=1e-30))
            check(rel <= MESH_GRAD_TOL,
                  f"phase {phase} {kind}: gradient {name} relative L2 error "
                  f"{rel:.3e} over {MESH_GRAD_TOL}")
            worst = max(worst, (rel, name))
        step.keep_grads = False
        step.engine.last_grads = None
    # the peak of the steps after the warm-up (whose first allocations
    # and gradient read-back are not the schedule's)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        losses.append(step.step(*args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = flash_counts(fa)
    check(fa.ROUTE_LAUNCHES["scalar"] == scalar0,
          f"phase {phase} {kind}: a flash launch took the scalar fp32 route")
    shape = mesh_shape(kind)
    units = (PIPE_MICRO[kind.rsplit("_", 1)[0]] * shape.get("dp", 1)
             if pipe else 4)
    want = {"fwd": (1 + recompute) * units * N_LAYERS,
            "bwd_dkv": units * N_LAYERS, "bwd_dq": units * N_LAYERS}
    check(launches == {n: c * steps for n, c in want.items()},
          f"phase {phase} {kind}: flash launches {launches} in {steps} "
          f"steps, not {want} a step ({units} "
          f"{'micro-batches' if pipe else 'ranks'} x {N_LAYERS} layers, "
          "the forward twice under recompute)")
    losses = [float(l) for l in losses]
    check(all(math.isfinite(l) for l in losses),
          f"phase {phase} {kind}: non-finite loss {losses}")
    if kind.endswith("_1f1b"):
        STORED_INPUTS[kind] = step.engine.max_stored_inputs
        POST_NUMEL[kind] = sum(p.numel() for p in model.post.parameters())
    if ref is None:
        del step, opt, model
        gc.collect()
        torch.cuda.empty_cache()
        return losses, launches, peak, None, None
    timed = steps - 1
    tps = x.numel() * timed / wall
    print(f"phase {phase} {kind}{'' if recompute else ' (no recompute)'}: "
          "losses " + " ".join(f"{l:.5f}" for l in losses)
          + f" worst gradient rel L2 {worst[0]:.3e} ({worst[1]}) warmup_s "
          f"{warm_s:.3f} s_per_step {wall / timed:.4f} tokens_per_s "
          f"{tps:.1f} peak_mem_gb {peak:.2f} state_gb (params + moments, "
          f"4 ranks) {state_gb:.2f} grads_gb {grads_gb:.2f} flash a step "
          + " ".join(f"{n} {c // steps}" for n, c in launches.items())
          + f" [{card}]", flush=True)
    if profile:
        mesh_profile(kind, step, args, card)
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses, launches, peak, wall / timed, tps


def mesh_profile(kind, step, args, card):
    """One more step under torch.profiler: the device's busy share, the
    kernels a step, and the device time under the collectives' labels
    (``mesh.all_reduce``, ``mesh.all_gather`` and their ``.backward``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    n_kernels = sum(e.count for e in dev)
    labels = {e.key: (e.count, e.device_time_total / 1e3) for e in events
              if e.key.startswith("mesh.")}
    print(f"phase 21 {kind} profile: one step wall_s {wall:.3f} "
          f"device_busy_s {busy_ms / 1e3:.3f} busy_share "
          f"{busy_ms / 1e3 / wall:.3f} kernels_a_step {n_kernels} "
          f"collectives " + " ".join(
              f"{k} {c}x {ms:.3f}ms" for k, (c, ms) in sorted(labels.items()))
          + f" [{card}]", flush=True)
    dev.sort(key=lambda e: -e.self_device_time_total)
    for e in dev[:8]:
        print(f"phase 21 {kind} profile kernel: "
              f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x "
              f"{e.key[:90]}", flush=True)


def mesh_flash_timing(fa, card):
    """B5a-B5c at mesh 3's per-rank shape beside SDPA at that shape."""
    import torch
    import torch.nn.functional as F
    B, S, H, D = MP_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, sm_scale=D ** -0.5)
    o, lse = fa.flash_fwd(q, k, v, None, **kw)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, di, None)
    fns = {"fwd": lambda: fa.flash_fwd(q, k, v, None, **kw),
           "bwd_dkv": lambda: fa.flash_bwd_dkv(*args, **kw),
           "bwd_dq": lambda: fa.flash_bwd_dq(*args, **kw)}
    out = {}
    for kernel, fn in fns.items():
        ms = cuda_time_ms(fn, iters=20, warmup=3)
        bound, by = flash_bound_ms(kernel, q)
        out[kernel] = ms
        print(f"phase 21 flash_{kernel} at [{B}, {S}, {H}, {D}] bf16: ms "
              f"{ms:.4f} bound_ms {bound:.4f} ({by}) [{card}]", flush=True)
    sq, sk, sv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdo = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True), iters=20)
    sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(
        sout, (sq, sk, sv), sdo, retain_graph=True), iters=20)
    print(f"phase 21 library at [{B}, {S}, {H}, {D}] bf16: "
          f"scaled_dot_product_attention forward {fwd:.4f} ms, backward "
          f"{bwd:.4f} ms; kernels fwd {out['fwd']:.4f} ms, dkv + dq "
          f"{out['bwd_dkv'] + out['bwd_dq']:.4f} ms [{card}]", flush=True)
    # the launches of the comparison are not the main path's
    zero_flash_counts(fa)


def mesh_reference(batch, card):
    """The one-device ``TrainStep`` on the dense model: its losses, its
    first step's gradients on the host, and its s a step."""
    import torch
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep
    model = mesh_model("ref")
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, opt, amp_level="O1")
    losses = [step.step(list(batch))]
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_TIMED):
        losses.append(step.step(list(batch)))
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / MESH_TIMED
    losses = [float(l) for l in losses]
    print(f"phase 21 reference (one device, O1, recompute, B="
          f"{batch[0].shape[0]}): losses "
          + " ".join(f"{l:.5f}" for l in losses)
          + f" s_per_step {secs:.4f} [{card}]", flush=True)
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return losses, grads


def mesh_train_phase(card, fa):
    """Phase 21: gpt3-1.3b trained over four meshes of four ranks on this
    card, against the one-device ``TrainStep``.  Returns the flash
    launches of the five runs by kernel, and for phase 23 each run's
    peak and the B=8 batch with its reference losses and gradients."""
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    t_phase = time.perf_counter()
    mesh_flash_timing(fa, card)
    V = GPT_CONFIGS["gpt3-1.3b"]["vocab_size"]
    total = {n: 0 for n in FLASH_KERNELS}
    peaks = {}
    for rows, kinds in ((TRAIN_B, MESH_RUNS[:3]), (PIPE_B, MESH_RUNS[3:])):
        batch = train_batch(V, rows, TRAIN_S, seed=0)
        ref_losses, ref_grads = mesh_reference(batch, card)
        for kind in kinds:
            losses, launches, peak, _, _ = mesh_run(
                kind, batch, fa, card, ref=ref_grads,
                profile=kind == "dp2_mp2")
            for n in total:
                total[n] += launches[n]
            peaks[kind] = peak
            np.testing.assert_allclose(losses, ref_losses,
                                       rtol=MESH_LOSS_RTOL,
                                       err_msg=f"phase 21 {kind}: losses")
            if kind in MESH_REPEATED:
                again, _, _, _, _ = mesh_run(kind, batch, fa, card,
                                             steps=MESH_REPEAT)
                check(again == losses[:MESH_REPEAT],
                      f"phase 21 {kind}: the same seed gave losses {again}, "
                      f"not {losses[:MESH_REPEAT]}")
        ref = (batch, ref_losses, ref_grads)
        del ref_grads
    memory = check_1f1b_memory("21", peaks, "pp4")
    print(f"phase 21: five runs within rtol {MESH_LOSS_RTOL} of the "
          f"one-device losses and gradient rel L2 {MESH_GRAD_TOL}; "
          f"{', '.join(MESH_REPEATED)} repeated exactly from the same "
          f"seed; {memory}; wall_s {time.perf_counter() - t_phase:.1f} "
          f"[{card}]", flush=True)
    return total, {"peaks": peaks, "ref8": ref}


def stage3_phase(card, fa):
    """``--stage3``: phase 21's ``sharding4_stage3`` run (B=4), its blocks
    with and then without ``use_recompute``, each held to the one-device
    step: what a stage-3 unit gathered a time costs beside the
    recomputation."""
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    batch = train_batch(GPT_CONFIGS["gpt3-1.3b"]["vocab_size"], TRAIN_B,
                        TRAIN_S, seed=0)
    ref_losses, ref_grads = mesh_reference(batch, card)
    for recompute in (True, False):
        losses, _, _, _, _ = mesh_run("sharding4_stage3", batch, fa, card,
                                      ref=ref_grads, phase="stage3",
                                      recompute=recompute)
        np.testing.assert_allclose(losses, ref_losses, rtol=MESH_LOSS_RTOL,
                                   err_msg="stage 3: losses")


# -- phase 23 -------------------------------------------------------------
MESH23_RUNS = ("dp2_pp2_gpipe", "dp2_pp2_1f1b", "mp2_pp2_gpipe")
MESH23_STEPS = 1 + 1               # a warm-up step and a timed step
STAGE3_GATHER_ALL_GB = 53.26       # phase 21's stage-3 peak when every
                                   # parameter was gathered at once
META_MESHES = {"dp2_mp2": dict(dp=2, mp=2), "dp2": dict(dp=2)}
META_B, META_S, META_STEPS, META_K = 4, 1024, 2, 2
META_RTOL = 1e-6                   # (d): relative L2 of every parameter


def meta_model():
    """gpt2-medium from seed 0 in fp32 at dropout 0 with its AdamW."""
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.optimizer import AdamW
    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0)
    return model, AdamW(learning_rate=1e-4, weight_decay=0.01,
                        parameters=model.parameters())


def meta_run(kind, shape, batch):
    """(d): ``meta_model`` under ``kind``'s meta-optimizer over ``shape``
    (every rank on this card), ``META_STEPS`` steps.  Returns (losses,
    each data rank's parameters on the host, s a step, peak GB)."""
    import math
    import torch
    from paddle_tpu_torch.distributed import build_mesh
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
    model, opt = meta_model()
    n = math.prod(shape.values())
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = build_mesh(devices=[dev] * n, **shape)
    step = (meta.LocalSGDStep(model, opt, mesh=mesh, k_steps=META_K)
            if kind == "localsgd" else meta.DGCStep(model, opt, mesh=mesh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step.step(list(batch)) for _ in range(META_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = [{k: t.detach().cpu() for k, t in p.items()}
              for p in step.params]
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return [float(l) for l in losses], params, wall / META_STEPS, peak


def local_sgd_reference(batch, dp):
    """LocalSGD written out, independent of the meta-optimizer: ``dp``
    models, each with its own AdamW, each taking ``META_K`` eager steps a
    call over its ``1 / META_K`` shares of its ``1 / dp`` of the rows,
    then every parameter set to the models' mean.  Returns (losses, each
    model's parameters on the host)."""
    import torch
    pairs = [meta_model() for _ in range(dp)]
    x, y = (a.reshape((dp, META_K, -1) + tuple(a.shape[1:])) for a in batch)
    losses = []
    for _ in range(META_STEPS):
        last = []
        for d, (model, opt) in enumerate(pairs):
            for i in range(META_K):
                loss = model(x[d, i], y[d, i])
                loss.backward()
                opt.step()
                opt.clear_grad()
            last.append(float(loss.detach()))
        losses.append(sum(last) / dp)
        with torch.no_grad():
            named = [dict(m.named_parameters()) for m, _ in pairs]
            for k in named[0]:
                mean = sum(p[k] for p in named) / dp
                for p in named:
                    p[k].copy_(mean)
    params = [{k: t.detach().cpu() for k, t in m.named_parameters()}
              for m, _ in pairs]
    del pairs
    gc.collect()
    torch.cuda.empty_cache()
    return losses, params


def worst_rel(pa, pb):
    """The largest relative L2 error of a parameter of ``pa`` against
    ``pb`` (lists of name -> tensor), with its name."""
    worst = (0.0, "none")
    for ra, rb in zip(pa, pb):
        for k, want in rb.items():
            rel = float((ra[k] - want).norm() / want.norm().clamp(min=1e-30))
            worst = max(worst, (rel, k))
    return worst


def meta_phase(card, fa):
    """Phase 23 (d): LocalSGD (k=2) over dp2 x mp2 against LocalSGD
    written out over two models, and DGC over dp2 x mp2 against DGC over
    dp2 alone from the same seed."""
    import math
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPT_CONFIGS
    batch = train_batch(GPT_CONFIGS["gpt2-medium"]["vocab_size"], META_B,
                        META_S, seed=0)
    # run -> what it is held to: losses within META_RTOL of LocalSGD's
    # written out, equal to DGC's over dp2 alone
    runs = {("localsgd", "dp2_mp2"): "the same written out over two models",
            ("dgc", "dp2_mp2"): "dgc over dp2 alone", ("dgc", "dp2"): None}
    res = {}
    for (kind, mesh), against in runs.items():
        zero_flash_counts(fa)
        losses, params, sps, peak = meta_run(kind, META_MESHES[mesh], batch)
        launches = flash_counts(fa)
        check(not any(launches.values()),
              f"phase 23 (d) {kind} {mesh}: S={META_S} launched a flash "
              f"kernel ({launches})")
        check(all(math.isfinite(l) for l in losses),
              f"phase 23 (d) {kind} {mesh}: non-finite loss {losses}")
        print(f"phase 23 (d) {kind} {mesh} gpt2-medium fp32 B={META_B} "
              f"S={META_S}: losses " + " ".join(f"{l:.5f}" for l in losses)
              + f" s_per_step {sps:.4f} tokens_per_s "
              f"{META_B * META_S / sps:.1f} peak_mem_gb {peak:.2f} "
              "flash a step 0 [" + card + "]", flush=True)
        res[kind, mesh] = losses, params
    res["ref"] = local_sgd_reference(batch, META_MESHES["dp2"]["dp"])
    for (kind, mesh), against in runs.items():
        if against is None:
            continue
        (la, pa) = res[kind, mesh]
        lb, pb = res["ref"] if kind == "localsgd" else res[kind, "dp2"]
        worst = worst_rel(pa, pb)
        same = (np.allclose(la, lb, rtol=META_RTOL, atol=0)
                if kind == "localsgd" else la == lb)
        check(worst[0] <= META_RTOL and same,
              f"phase 23 (d) {kind} {mesh} against {against}: losses {la} / "
              f"{lb}, parameter {worst[1]} relative L2 {worst[0]:.3e} over "
              f"{META_RTOL}")
        print(f"phase 23 (d) {kind} {mesh} equals {against}: losses "
              + " / ".join(f"{l:.5f}" for l in lb) + ", worst parameter "
              f"relative L2 {worst[0]:.3e} ({worst[1]}; limit {META_RTOL}) "
              f"[{card}]", flush=True)


def mesh_rest_phase(card, fa, phase21):
    """Phase 23: (a) gpt3-1.3b over dp2 x pp2, GPipe with recompute then
    1F1B, and (b) over mp2 x pp2 (GPipe, a vocab-parallel embedding and
    head), held to phase 21's one-device reference at B=8; (c) ZeRO-3 a
    unit at a time: phase 21's stage-3 peak beside its stage-2 peak and
    the gather-all's; (d) the meta-optimizers beside mp.  Returns the
    flash launches of (a) and (b) by kernel."""
    import numpy as np
    t_phase = time.perf_counter()
    total = {n: 0 for n in FLASH_KERNELS}
    batch, ref_losses, ref_grads = phase21["ref8"]
    peaks23 = {}
    for kind in MESH23_RUNS:
        label = "23 (a)" if kind.startswith("dp2") else "23 (b)"
        losses, launches, peaks23[kind], _, _ = mesh_run(
            kind, batch, fa, card, ref=ref_grads, steps=MESH23_STEPS,
            phase=label)
        np.testing.assert_allclose(
            losses, ref_losses[:MESH23_STEPS], rtol=MESH_LOSS_RTOL,
            err_msg=f"phase {label} {kind}: losses")
        for n in total:
            total[n] += launches[n]
    print(f"phase 23 (a): {check_1f1b_memory('23 (a)', peaks23, 'dp2_pp2')}"
          f" [{card}]", flush=True)
    peaks = phase21["peaks"]
    s3, s2 = peaks["sharding4_stage3"], peaks["dp2_sharding2_stage2"]
    print(f"phase 23 (c) ZeRO-3 a unit at a time: sharding4_stage3 "
          f"peak_mem_gb {s3:.2f} beside dp2_sharding2_stage2 {s2:.2f} "
          f"(both phase 21, this run) and the gather-all stage 3's "
          f"{STAGE3_GATHER_ALL_GB:.2f} (PERF.md) [{card}]", flush=True)
    check(s3 < s2, f"phase 23 (c): stage 3's peak {s3:.2f} GB is not "
          f"below stage 2's {s2:.2f} GB")
    meta_phase(card, fa)
    print(f"phase 23 wall_s {time.perf_counter() - t_phase:.1f} [{card}]",
          flush=True)
    return total


# -- phase 22 -------------------------------------------------------------
MESH_MIGRATE_REQS = 6              # phase 22 (d): phase 4's first requests
BN_SHAPE = (16, 3, 32, 32)         # phase 22 (e): images a step, NCHW
BN_STEPS = 4
BN_RTOL = 1e-4


def mesh_line(label, eng, wall, extra, card):
    """A phase 22 sub-phase's line: tokens/s beside its profiled window's
    kernels a tick and busy share (``PROFILES``)."""
    share, kpt = PROFILES[label]
    print(f"phase 22{label}: tokens_per_s "
          f"{eng.tokens_generated / wall:.2f} kernels_per_tick {kpt:.1f} "
          f"busy_share {share:.3f}{extra} [{card}]", flush=True)


def mesh_xla_phase(card, ragged_mod, fa, model, reqs, xla_outs):
    """Phase 22 (a): phase 16's five serves (``XLA_SERVES``) on phase
    14's (2, 2) mesh of the tensor-parallel model.  Each greedy token is
    the dense argmax (phase 4's near-tie rule), each stream equals phase
    16's stream of its serve except from a near tie (device-mode seeded
    ones, except at a draw shown on a cumulative edge; host-mode seeded
    ones are counted), no flash kernel launches, the XLA serves no ragged
    kernel, the ragged decode after a monolithic prefill (c) B4 over B1.
    A profiled window of (a), its kernels a tick by launching op beside
    phase 16's.  Returns (c)'s B4 launches."""
    from paddle_tpu_torch.serving import Engine
    tp = model.to_tensor_parallel()
    b4 = 0
    for tag, name, kw in XLA_SERVES:
        label = f"phase 22 (a) mesh {tag} {name}"
        zero_ragged_counts(ragged_mod)
        zero_flash_counts(fa)
        eng, outs, wall = serve(tp, reqs, Engine, mesh=one_card_mesh(), **kw)
        if eng._ragged:
            b4 += check_mesh_launches(ragged_mod, eng,
                                      "ragged_paged_attention", label)
        else:
            check(not any(ragged_counts(ragged_mod).values()),
                  f"{label}: a ragged kernel launched")
        check(not any(flash_counts(fa).values()),
              f"{label}: a flash kernel launched")
        for (p, _), ids in zip(reqs, outs):
            check(len(ids) == len(p) + 32, f"{label}: a stream is short")
        checked, near = teacher_forcing(model, reqs, outs)
        host = eng.sample_mode == "host"
        if host:
            greedy = [(r, a, b) for r, a, b in zip(reqs, outs, xla_outs[tag])
                      if not r[1]]
            g_eq, g_n, _, _ = check_against(model, *zip(*greedy), label)
            s_eq = sum(a.tolist() == b.tolist() for (_, rkw), a, b in
                       zip(reqs, outs, xla_outs[tag]) if rkw)
            s_n = 2
        else:
            g_eq, g_n, s_eq, s_n = check_against(model, reqs, outs,
                                                 xla_outs[tag], label)
        slice_line(f"gpt2-medium fp32 phase 22 (a) mesh {MESH_SHAPE} {tag} "
                   f"{name}", eng, wall, b4 if eng._ragged else 0, card,
                   f" greedy_checked {checked} near_ties {near} "
                   f"greedy_equal_to_phase16 {g_eq}/{g_n} "
                   f"seeded_equal_to_phase16 {s_eq}/{s_n}")
        if tag == "a":
            a_eng, a_wall = eng, wall
        del eng
    profile_phase(tp, reqs, Engine, card, label=" (a) mesh xla",
                  breakdown=True, mesh=one_card_mesh(), **XLA_DEFAULT)
    mesh_line(" (a) mesh xla", a_eng, a_wall, " (serve a: contiguous, "
              "whole-prompt prefill)", card)
    print_breakdown(" (a) mesh xla", " xla")
    check(not any(ragged_counts(ragged_mod).values()),
          "phase 22 (a): the XLA mesh path launched a ragged kernel")
    return b4


def mesh_int8_weights_phase(card, ragged_mod, reqs, w_outs):
    """Phase 22 (b): a fresh gpt2-medium (seed 0) with ``weight_dtype=
    "int8"`` on a ``(1, 2)`` mesh of ``cuda:0`` (the dense int8 blocks
    served as they are on both dp ranks): B4 over B1 once per layer and dispatch,
    greedy tokens the argmax of the int8 model's dense forward, streams
    equal phase 9's unsharded int8-weight streams except at near ties.
    Returns B4's launches."""
    import torch
    from paddle_tpu_torch.distributed import ServingMesh
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine
    model = GPTModel.from_config("gpt2-medium", seed=0, dropout=0.0,
                                 num_layers=SERVE_LAYERS)
    mesh = ServingMesh(1, 2, devices=[torch.device("cuda", 0)] * 2)
    zero_ragged_counts(ragged_mod)
    eng, outs, wall = serve(model, reqs, Engine, mesh=mesh,
                            weight_dtype="int8")
    label = "phase 22 (b) int8 weights (1, 2)"
    b4 = check_mesh_launches(ragged_mod, eng, "ragged_paged_attention",
                             label)
    check(eng._runner.dense is not None,
          f"{label}: the mesh did not serve the dense int8 blocks")
    checked, near = teacher_forcing(model, reqs, outs)
    g_eq, g_n, s_eq, s_n = check_against(model, reqs, outs, w_outs, label)
    slice_line("gpt2-medium weight_dtype=int8 phase 22 (b) mesh (1, 2)",
               eng, wall, b4, card,
               f" greedy_checked {checked} near_ties {near} "
               f"greedy_equal_to_phase9 {g_eq}/{g_n} seeded_equal_to_phase9 "
               f"{s_eq}/{s_n}")
    zero_ragged_counts(ragged_mod)
    profile_phase(model, reqs, Engine, card, label=" (b) mesh int8w",
                  mesh=mesh)
    b4 += ragged_counts(ragged_mod)["sharded_ragged_paged_attention"]
    mesh_line(" (b) mesh int8w", eng, wall, "", card)
    del model, eng
    torch.cuda.empty_cache()
    return b4


def mesh_migration_phase(card, ragged_mod, model, reqs, fp_outs):
    """Phase 22 (d): phase 4's first ``MESH_MIGRATE_REQS`` requests
    exported after ``MIGRATE_AFTER`` tokens from phase 14's (2, 2) mesh
    into one device, and from one device into the mesh (every other
    payload through the JSON wire): every stream equal to phase 4's
    except at near ties, B4 launched once per layer and mesh dispatch
    and B1 once per layer and unsharded one besides; the second direction's importing
    mesh profiled.  Returns (B4 launches, B1 launches)."""
    tp = model.to_tensor_parallel()
    sub = reqs[:MESH_MIGRATE_REQS]
    refs = fp_outs[:MESH_MIGRATE_REQS]
    b4 = b1 = 0
    for direction, a_model, b_model, a_kw, b_kw, prof in (
            ("mesh -> one device", tp, model, dict(mesh=one_card_mesh()),
             dict(mesh=None), None),
            ("one device -> mesh", model, tp, {},
             dict(mesh=one_card_mesh()), (card, " (d) mesh migration"))):
        label = f"phase 22 (d) {direction}"
        zero_ragged_counts(ragged_mod)
        a, b, payloads, outs, wall, _ = migrate_pair(
            a_model, sub, refs, b_model=b_model, b_kw=b_kw, profile=prof,
            **a_kw)
        mesh_eng, one_eng = (a, b) if a.mesh is not None else (b, a)
        counts = ragged_counts(ragged_mod)
        n4 = counts["sharded_ragged_paged_attention"]
        n1 = counts["ragged_paged_attention"]
        check(n4 == mesh_eng.ragged_dispatches * SERVE_LAYERS,
              f"{label}: B4 launched {n4} times, not "
              f"{mesh_eng.ragged_dispatches} mesh dispatches x {SERVE_LAYERS}")
        check(n1 == n4 + one_eng.ragged_dispatches * SERVE_LAYERS,
              f"{label}: B1 launched {n1} times, not B4's {n4} + "
              f"{one_eng.ragged_dispatches} dispatches x {SERVE_LAYERS}")
        b4 += n4
        b1 += n1 - n4
        g_eq, g_n, s_eq, s_n = check_against(model, sub, outs, refs, label)
        blocks = sum(pl["kv"]["n_blocks"] for pl in payloads)
        heads = model.blocks[0].attn.num_heads
        check(all(pl["kv"]["data"].shape[4] == heads for pl in payloads),
              f"{label}: a payload is not in the global head layout")
        print(f"{label}: {len(sub)} streams after {MIGRATE_AFTER} tokens, "
              f"blocks {blocks}, greedy_equal_to_phase4 {g_eq}/{g_n} "
              f"seeded_equal {s_eq}/{s_n}, export_span_ms_mean "
              f"{span_ms(a, ('migrate.export',)):.4f} import_span_ms_mean "
              f"{span_ms(b, ('migrate.import',)):.4f} wall_s {wall:.3f} "
              f"tokens_per_s {(a.tokens_generated + b.tokens_generated) / wall:.2f}"
              + (" (a window of B profiled)" if prof else "")
              + f" [{card}]", flush=True)
    share, kpt = PROFILES[" (d) mesh migration"]
    print(f"phase 22 (d): the importing mesh's kernels_per_tick {kpt:.1f} "
          f"busy_share {share:.3f} [{card}]", flush=True)
    return b4, b1


def mesh_bn_phase(card):
    """Phase 22 (e): a conv net with the port's ``BatchNorm2D`` trained
    ``BN_STEPS`` SGD steps by ``TrainStep`` over a dp2 mesh of two ranks
    on ``cuda:0``, the batch split, against the one-device step on the
    same weights and batch: losses, parameters and running statistics
    within ``BN_RTOL`` (the statistics are the whole batch's on every
    rank)."""
    import copy

    import numpy as np
    import torch
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.distributed import build_mesh
    from paddle_tpu_torch.nn.layer import BatchNorm2D
    from paddle_tpu_torch.parallel import TrainStep
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 32, 3, padding=1), BatchNorm2D(32),
        torch.nn.ReLU(), torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        torch.nn.Linear(32, 10)).to(dev)
    nets = [net, copy.deepcopy(net)]
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(*BN_SHAPE).astype(np.float32), device=dev)
    y = torch.tensor(rng.randn(BN_SHAPE[0], 10).astype(np.float32),
                     device=dev)
    out = []
    for net, mesh in ((nets[0], build_mesh(dp=2, devices=[dev] * 2)),
                      (nets[1], None)):
        st = TrainStep(net, topt.SGD(learning_rate=0.1,
                                     parameters=net.parameters(),
                                     device=dev),
                       loss_fn=torch.nn.MSELoss(), mesh=mesh, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(st.step([x], [y])) for _ in range(BN_STEPS)]
        torch.cuda.synchronize()
        out.append((losses, (time.perf_counter() - t0) / BN_STEPS))
        st.sync_to_layer()
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=BN_RTOL,
                               err_msg="phase 22 (e): losses")
    worst = 0.0
    for (n, a), (_, b) in zip(
            [*nets[0].named_parameters(), *nets[0].named_buffers()],
            [*nets[1].named_parameters(), *nets[1].named_buffers()]):
        a, b = a.detach(), b.detach()
        if a.is_floating_point():
            err = float((a - b).abs().max() / (b.abs().max() + 1e-12))
            check(err < BN_RTOL, f"phase 22 (e): {n} differs by {err:.3e} "
                  "of its largest entry from the one-device step's")
            worst = max(worst, err)
    print(f"phase 22 (e) batch norm over dp2: {BN_STEPS} steps of "
          f"{BN_SHAPE}, losses {out[0][0]} (one device {out[1][0]}), worst "
          f"relative parameter / statistic difference {worst:.3e}, s a step "
          f"{out[0][1]:.4f} (one device {out[1][1]:.4f}) [{card}]",
          flush=True)


def mesh_serving_phase(card, ragged_mod, fa, model, reqs, fp_outs, xla_outs,
                       w_outs):
    """Phase 22: the rest of serving over the mesh, and batch norm over a
    split batch.  Returns (B4 launches, B1 launches) of its serves."""
    t0 = time.perf_counter()

    def lap(sub):
        print(f"phase 22 ({sub}) done at {time.perf_counter() - t0:.1f} s "
              "into phase 22", flush=True)

    b4 = mesh_xla_phase(card, ragged_mod, fa, model, reqs, xla_outs)
    lap("a")
    b4 += mesh_int8_weights_phase(card, ragged_mod, reqs, w_outs)
    lap("b")
    b4 += offload_serve(card, ragged_mod, model.to_tensor_parallel(),
                        "mesh host tier fp32", "ragged_paged_attention",
                        mesh=True)
    lap("c")
    n4, b1 = mesh_migration_phase(card, ragged_mod, model, reqs, fp_outs)
    lap("d")
    mesh_bn_phase(card)
    lap("e")
    return b4 + n4, b1


# -- phase 24 -------------------------------------------------------------
SWEEP_MODULES = ("math", "creation", "manipulation", "linalg", "compat_ops")
SPARSE_SHAPE = (50304, 1024, 8, 1024)   # gpt2-medium's token table, ids
RAGGED_CAPACITY = 8192                  # tokens, in RAGGED_ROWS sequences
RAGGED_ROWS = 64
RAGGED_DIM = 1024                       # gpt2-medium's width
RAGGED_TOL = (1e-5, 1e-5)               # rtol, atol against the CPU


def tests_module(name):
    """A helper module of tests/ that imports numpy and the port only."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def op_sweep(P, C):
    """(a): every case of tests/torch_op_cases.py on the card against the
    CPU, gradients too; ``(ops held, worst error per module)``."""
    missing = C.uncovered(P)
    check(not missing, f"phase 24 (a): no case covers {missing}")
    owner = {}
    for mod in SWEEP_MODULES:
        for n in getattr(P.ops, mod).__all__:
            owner.setdefault(n, mod)
    worst, held = {}, set()
    for case in C.CASES:
        cid, covers, _, _, tol, grad = case
        label = next((owner[c] for c in covers if c in owner),
                     "autograd" if covers == ("grad",) else "Tensor")
        P.set_device("gpu")
        places = C.output_places(P, case)
        check(all(p.is_gpu_place() for p in places),
              f"phase 24 (a): {cid} left the card: {places}")
        for g in ((False, True) if grad else (False,)):
            P.set_device("cpu")
            want = C.run_case(P, case, g)
            P.set_device("gpu")
            got = C.run_case(P, case, g)
            err = 0.0
            for k, (a, b) in enumerate(zip(got[0], want[0])):
                err = max(err, C.compare(a, b, tol,
                                         f"phase 24 (a) {cid} output {k}"))
            if g:
                err = max(err, C.compare_grads(got[1], want[1], tol,
                                               f"phase 24 (a) {cid}"))
            worst[label] = max(worst.get(label, 0.0), err)
        held.update(covers)
    return held, worst


def random_ops_on_card(P, C):
    """(a)'s random ops: the same seed repeats each stream on the card,
    and the values lie in their range."""
    import numpy as np
    draws = {
        "rand": lambda: P.rand([4096]), "randn": lambda: P.randn([4096]),
        "standard_normal": lambda: P.standard_normal([64]),
        "uniform": lambda: P.uniform([4096], min=2.0, max=3.0),
        "normal": lambda: P.normal(1.0, 0.5, [4096]),
        "randint": lambda: P.randint(0, 7, [4096]),
        "randint_like": lambda: P.randint_like(P.zeros([64], "int32"), 0, 3),
        "randperm": lambda: P.randperm(1000),
        "bernoulli": lambda: P.bernoulli(P.full([4096], 0.25)),
        "multinomial": lambda: P.multinomial(P.to_tensor(
            np.array([0.2, 0.0, 0.8], np.float32)), 64, replacement=True),
        "poisson": lambda: P.poisson(P.full([4096], 3.0)),
    }
    check(set(draws) == set(C.RANDOM_OPS), "phase 24 (a): random ops")
    for name, draw in draws.items():
        P.seed(7)
        a = draw()
        check(a.place.is_gpu_place(), f"phase 24 (a): {name} off the card")
        P.seed(7)
        check(np.array_equal(a.numpy(), draw().numpy()),
              f"phase 24 (a): {name} did not repeat under one seed")
    P.seed(0)
    r = P.rand([100000]).numpy()
    check(r.min() >= 0 and r.max() < 1 and abs(r.mean() - 0.5) < 0.01,
          "phase 24 (a): rand out of range")
    check(sorted(P.randperm(1000).tolist()) == list(range(1000)),
          "phase 24 (a): randperm is no permutation")
    m = P.multinomial(P.to_tensor(np.array([0.2, 0.0, 0.8], np.float32)),
                      256, replacement=True).numpy()
    check(1 not in m, "phase 24 (a): multinomial drew a zero-weight class")
    return len(draws)


def sparse_phase(P, S, card):
    """(b): gpt2-medium's token table trained through sparse gradients."""
    import torch

    def timer(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    vocab, dim, batch, seq = SPARSE_SHAPE
    res = S.check_all(P, vocab, dim, batch, seq, timer=timer)
    for name, r in res.items():
        dense = (f", dense {r['dense_ms']:.4f} ms a step, max relative "
                 f"difference to the dense update {r['max_rel_vs_dense']:.3g}"
                 if "dense_ms" in r else "")
        extra = (f", untouched rows bit-identical: {r['untouched_rows']}"
                 if "untouched_rows" in r else "")
        if "max_abs_vs_rows" in r:
            extra += (f", max |w - row-by-row rule| "
                      f"{r['max_abs_vs_rows']:.3g}")
        print(f"phase 24 (b) {name}: sparse {r['ms']:.4f} ms a step (the "
              f"median of {S.TIMED_STEPS} after a warm-up step){dense}"
              f"{extra} [{card}]", flush=True)
    g = res["sgd"]
    print(f"phase 24 (b) gradient bytes: values {g['grad_bytes']} "
          f"({g['grad_bytes'] / 1e6:.1f} MB) against dense "
          f"{g['dense_grad_bytes']} ({g['dense_grad_bytes'] / 1e6:.1f} MB)",
          flush=True)
    check(g["grad_bytes"] == batch * seq * dim * 4 and
          g["dense_grad_bytes"] == vocab * dim * 4,
          "phase 24 (b): gradient sizes")
    w0, ids = S.make_inputs(vocab, dim, batch, seq)
    for name, sparse in (("adam_lazy", True), ("adam", False)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        S.train(P, name, w0, ids, sparse, S.STEPS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"phase 24 (b) peak memory over a {name} "
              f"{'sparse' if sparse else 'dense'} run: {peak / 1e6:.1f} MB "
              f"[{card}]", flush=True)


def py_func_on_card(P):
    """(c): a numpy forward and a hand-given backward on a card tensor,
    output and gradient equal to the CPU's."""
    import numpy as np
    x = np.linspace(-1.5, 1.5, 4096, dtype=np.float32).reshape(64, 64)
    outs = {}
    for dev in ("cpu", "gpu"):
        P.set_device(dev)
        t = P.to_tensor(x, stop_gradient=False)
        out = P.py_func(np.tanh, t, P.zeros([64, 64]),
                        backward_func=lambda a, y, dy: [dy * (1 - y * y)])
        P.sum(out * out).backward()
        check(out.place.is_gpu_place() == (dev == "gpu"),
              f"phase 24 (c): py_func output on {out.place}")
        outs[dev] = (out.numpy(), t.grad.numpy())
    for k in range(2):
        np.testing.assert_allclose(outs["gpu"][k], outs["cpu"][k],
                                   rtol=1e-6, atol=0)
    return float(np.max(np.abs(outs["gpu"][1] - outs["cpu"][1])))


def ragged_lengths():
    """64 skewed lengths in 8192 tokens: BASELINE.md's ragged-skew corpus
    shape (lognormal, median 166, p90 682, max 2048): one row at the max,
    63 lognormal draws scaled together to fill the rest of the budget."""
    import numpy as np
    rs = np.random.RandomState(0)
    sigma = (np.log(682) - np.log(166)) / 1.2816
    draws = rs.lognormal(np.log(166), sigma, RAGGED_ROWS - 1)
    room = RAGGED_CAPACITY - 2048
    lens = np.maximum(np.floor(draws * room / draws.sum()), 1).astype(int)
    return [2048] + [int(n) for n in lens]


def ragged_on_card(P, card):
    """(d): the sequence ops over a RaggedTensor of capacity 8192 on the
    card against the CPU, at rtol 1e-5: of each value for the ops that
    add no numbers up in another order (max, first, last, softmax's
    positive sums, expand), of the sum of the absolute terms for sum and
    mean (the card adds a row's terms in another order, and a sum of
    terms of both signs keeps only the absolute error)."""
    import numpy as np
    from paddle_tpu_torch.core import ragged as R
    lens = ragged_lengths()
    rs = np.random.RandomState(1)
    rows = [rs.randn(n, RAGGED_DIM).astype(np.float32) for n in lens]
    rows1 = [rs.randn(n).astype(np.float32) for n in lens]
    steps = rs.randn(RAGGED_ROWS, RAGGED_DIM).astype(np.float32)
    l1 = np.stack([np.abs(r.astype(np.float64)).sum(0) for r in rows])
    scale = {"sum": l1, "mean": l1 / np.array(lens)[:, None]}
    results = {}
    for dev in ("cpu", "gpu"):
        P.set_device(dev)
        rt = R.RaggedTensor.from_rows(rows, capacity=RAGGED_CAPACITY)
        rt1 = R.RaggedTensor.from_rows(rows1, capacity=RAGGED_CAPACITY)
        x = R.RaggedTensor(P.to_tensor(steps), P.arange(
            RAGGED_ROWS + 1).astype("int32"))
        out = {p: R.sequence_pool(rt, p) for p in
               ("sum", "mean", "max", "first", "last")}
        out["softmax"] = R.sequence_softmax(rt1).values
        out["expand"] = R.sequence_expand(x, rt).values
        if dev == "gpu":
            for k, v in out.items():
                check(v.place.is_gpu_place(), f"phase 24 (d): {k} off the "
                      "card")
            times = {"pool mean": cuda_time_ms(
                lambda: R.sequence_pool(rt, "mean"), iters=10),
                "softmax": cuda_time_ms(lambda: R.sequence_softmax(rt1),
                                        iters=10),
                "expand": cuda_time_ms(lambda: R.sequence_expand(x, rt),
                                       iters=10)}
        results[dev] = {k: v.numpy() for k, v in out.items()}
    worst = {}
    for k in results["cpu"]:
        a = results["gpu"][k].astype(np.float64)
        b = results["cpu"][k].astype(np.float64)
        bound = RAGGED_TOL[0] * scale.get(k, np.abs(b)) + RAGGED_TOL[1]
        ratio = float(np.max(np.abs(a - b) / bound))
        check(ratio <= 1.0, f"phase 24 (d) {k}: the card differs from the "
              f"CPU by {ratio:.3g} of the tolerance")
        worst[k] = float(np.max(np.abs(a - b)))
    print(f"phase 24 (d) ragged: {RAGGED_ROWS} sequences, {sum(lens)} of "
          f"{RAGGED_CAPACITY} tokens (median {int(np.median(lens))}, max "
          f"{max(lens)}), width {RAGGED_DIM}: the card equals the CPU, "
          "max abs " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + "; ms on the card: "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f" [{card}]", flush=True)


def tensor_layer_phase(card):
    """Phase 24: the Paddle tensor layer on the card (see the module
    docstring)."""
    import paddle_tpu_torch as P
    C = tests_module("torch_op_cases")
    S = tests_module("torch_sparse_checks")
    t0 = time.perf_counter()
    held, worst = op_sweep(P, C)
    n_random = random_ops_on_card(P, C)
    print(f"phase 24 (a) op sweep: {len(C.CASES)} cases holding "
          f"{len(held)} functions and dunders, {n_random} random ops "
          "repeated under one seed; worst abs error by module: "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
          + f" ({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    P.set_device("gpu")
    sparse_phase(P, S, card)
    err = py_func_on_card(P)
    print(f"phase 24 (c) py_func on a card tensor: output and gradient "
          f"equal the CPU's (max abs {err:.3g})", flush=True)
    ragged_on_card(P, card)
    P.set_device("gpu")


# -- phase 25 -------------------------------------------------------------
# (a): Vaswani et al. 2017's base model (nn.Transformer's defaults) with a
# shared 37,000-token vocabulary; B pairs of S tokens a side (the paper's
# 25,000-token batches cut to 8,192 a side for time)
NN_VOCAB = 37000
NN_B, NN_S = 64, 128
NN_TIMED = 3                       # steps after the warm-up step
NN_CPU_PAIRS = 4                   # the CPU's slice of the batch
NN_DECODE_STEPS = 32               # (b)
NN_FLASH_B, NN_FLASH_S = 2, 2048   # (c)
NN_FLASH_RATIO = 1.5               # (c): kernels' / plain bf16's distance
# (d): PaddleNLP examples/machine_translation/seq2seq on IWSLT'15 en-vi
NN_SRC_VOCAB, NN_TGT_VOCAB = 17191, 7709
NN_RNN_WIDTH, NN_RNN_LAYERS = 512, 2
NN_RNN_B, NN_RNN_T, NN_RNN_STEPS = 128, 50, 3
NN_BEAM, NN_BEAM_STEPS, NN_BEAM_SOURCES = 10, 50, 16
NN_TIE_MARGIN = 1e-4
NN_BEAM_RTOL = 1e-4                # (d): the hypotheses' scores
NN_HEAD_SCALE = 64.0


def nn_models(P):
    """The model classes of phase 25, written as a Paddle user writes
    them (``nn.Layer`` subclasses over the port's ``nn``)."""
    import math
    nn, F = P.nn, P.nn.functional

    class Seq2SeqTransformer(nn.Layer):
        """The base Transformer between a shared embedding (scaled by
        sqrt(d_model), sinusoidal positions) and a linear head."""

        def __init__(self, vocab, d_model=512):
            super().__init__()
            self.d_model = d_model
            self.embedding = nn.Embedding(vocab, d_model)
            self.transformer = nn.Transformer(d_model)
            self.head = nn.Linear(d_model, vocab)

        def embed(self, ids):
            return F.add_position_encoding(self.embedding(ids),
                                           alpha=math.sqrt(self.d_model))

        def forward(self, src, tgt):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt.shape[1])
            return self.head(self.transformer(self.embed(src),
                                              self.embed(tgt),
                                              tgt_mask=mask))

    class StackedLSTMCell(nn.RNNCellBase):
        """Two ``LSTMCell`` as one cell: states ``[(h, c), (h, c)]``."""

        def __init__(self, width, layers):
            super().__init__()
            self.hidden_size = width
            self.cells = nn.LayerList([nn.LSTMCell(width, width)
                                       for _ in range(layers)])

        def forward(self, inputs, states):
            new = []
            for cell, state in zip(self.cells, states):
                inputs, state = cell(inputs, state)
                new.append(state)
            return inputs, new

    class Seq2SeqLSTM(nn.Layer):
        """An LSTM encoder and a stacked-cell decoder started from the
        encoder's final states (PaddleNLP's seq2seq without attention)."""

        def __init__(self):
            super().__init__()
            w, n = NN_RNN_WIDTH, NN_RNN_LAYERS
            self.src_embedding = nn.Embedding(NN_SRC_VOCAB, w)
            self.tgt_embedding = nn.Embedding(NN_TGT_VOCAB, w)
            self.encoder = nn.LSTM(w, w, n)
            self.cell = StackedLSTMCell(w, n)
            self.decoder = nn.RNN(self.cell)
            self.output = nn.Linear(w, NN_TGT_VOCAB)

        def encode(self, src):
            _, (h, c) = self.encoder(self.src_embedding(src))
            return [(h[k], c[k]) for k in range(NN_RNN_LAYERS)]

        def forward(self, src, tgt):
            out, _ = self.decoder(self.tgt_embedding(tgt), self.encode(src))
            return self.output(out)

    return Seq2SeqTransformer, Seq2SeqLSTM


def nn_cpu_copy(P, make, layer):
    """A CPU copy of ``layer`` (built by ``make()``) holding its weights."""
    from paddle_tpu_torch import convert
    P.set_device("cpu")
    try:
        cpu = make()
        convert.load_layer_state(cpu, convert.export_layer_state(layer))
    finally:
        P.set_device("gpu")
    return cpu


def nn_step_profile(step, card, label):
    """One step under torch.profiler: kernels a step and the device's busy
    share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    n = sum(e.count for e in dev)
    print(f"{label} profile: one step {n} kernels, wall_s {wall:.3f} "
          f"device_busy_s {busy:.3f} busy_share {busy / wall:.3f} [{card}]",
          flush=True)
    return n, busy / wall


def nn_transformer_phase(P, card):
    """(a) and (b): the base Transformer trained 1 + NN_TIMED steps on a
    seeded batch, its first loss against the port's on the CPU, then
    incremental decoding against the full forward."""
    import numpy as np
    import torch
    Seq2SeqTransformer, _ = nn_models(P)
    P.set_device("gpu")
    P.seed(0)
    model = Seq2SeqTransformer(NN_VOCAB)
    n_params = sum(p.size for p in model.parameters())
    rs = np.random.RandomState(0)
    src = rs.randint(3, NN_VOCAB, (NN_B, NN_S))
    tgt = rs.randint(3, NN_VOCAB, (NN_B, NN_S + 1))
    x, y_in, y = (P.to_tensor(src), P.to_tensor(tgt[:, :-1]),
                  P.to_tensor(tgt[:, 1:]))
    ce = P.nn.CrossEntropyLoss()

    def loss_of(m, a, b, c):
        return ce(P.reshape(m(a, b), [-1, NN_VOCAB]), P.reshape(c, [-1]))

    # the first loss on the card against the port's CPU loss (dropout
    # off, the same weights, a slice of the batch)
    k = NN_CPU_PAIRS
    model.eval()
    card_loss = float(loss_of(model, x[:k], y_in[:k], y[:k]))
    cpu = nn_cpu_copy(P, lambda: Seq2SeqTransformer(NN_VOCAB), model).eval()
    P.set_device("cpu")
    try:
        with P.no_grad():
            cpu_loss = float(loss_of(cpu, *(P.to_tensor(a[:k]) for a in (
                src, tgt[:, :-1], tgt[:, 1:]))))
    finally:
        P.set_device("gpu")
    del cpu
    check(abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss),
          f"phase 25 (a): the card's loss {card_loss} vs the CPU's "
          f"{cpu_loss} on {k} pairs")
    model.train()
    opt = P.optimizer.Adam(learning_rate=1e-4, beta1=0.9, beta2=0.98,
                           epsilon=1e-9, parameters=model.parameters(),
                           grad_clip=P.nn.ClipGradByGlobalNorm(1.0))
    losses = []

    def step():
        loss = loss_of(model, x, y_in, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(NN_TIMED):
        step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / NN_TIMED
    peak = torch.cuda.max_memory_allocated() / 1e9
    kernels, busy = nn_step_profile(step, card, "phase 25 (a)")
    vals = [float(v) for v in losses]
    check(all(np.isfinite(vals)), f"phase 25 (a): losses {vals}")
    check(vals[-1] < vals[0], f"phase 25 (a): the loss did not fall {vals}")
    print(f"phase 25 (a) Transformer-base ({n_params / 1e6:.1f} M "
          f"parameters, vocab {NN_VOCAB}, B={NN_B}, S={NN_S} a side, fp32, "
          f"Adam + ClipGradByGlobalNorm(1.0)): first loss {card_loss:.6f} "
          f"on the card vs {cpu_loss:.6f} on the CPU ({k} pairs, dropout "
          f"off); losses " + " ".join(f"{v:.4f}" for v in vals)
          + f"; {step_s * 1e3:.1f} ms a step, "
          f"{NN_B * NN_S / step_s:.0f} target tokens/s "
          f"({2 * NN_B * NN_S / step_s:.0f} both sides), peak "
          f"{peak:.2f} GB, {kernels} kernels a step, busy share "
          f"{busy:.3f} [{card}]", flush=True)

    # (b) incremental decoding with the trained weights
    model.eval()
    tr = model.transformer
    n = NN_DECODE_STEPS
    with P.no_grad():
        memory = tr.encoder(model.embed(x[:k]))
        tgt_e = model.embed(y_in[:k, :n])
        full = tr.decoder(tgt_e, memory,
                          tgt_mask=tr.generate_square_subsequent_mask(n))
        cache = tr.decoder.gen_cache(memory)
        static = [c[1].k.torch() for c in cache]
        worst = 0.0
        for t in range(n):
            out, cache = tr.decoder(tgt_e[:, t:t + 1], memory, cache=cache)
            worst = max(worst, float(P.max(P.abs(
                out[:, 0] - full[:, t]))))
    check(worst <= 1e-4, f"phase 25 (b): incremental decoding differs from "
          f"the full forward by {worst}")
    check(all(c[1].k.torch() is s for c, s in zip(cache, static)),
          "phase 25 (b): the static cross-attention cache was rebuilt")
    check(cache[0][0].k.shape[1] == n, "phase 25 (b): the cache did not "
          "grow one position a step")
    print(f"phase 25 (b) incremental decoding: gen_cache + {n} one-token "
          f"steps equal the full causal forward at every position (max abs "
          f"{worst:.3g}, tolerance 1e-4); the StaticCache made once "
          f"[{card}]", flush=True)
    del model, opt, losses
    gc.collect()
    torch.cuda.empty_cache()


def nn_flash_phase(P, fa, card):
    """(c): the Layer TransformerEncoder at base width in bf16 under
    amp.auto_cast on the flash kernels, against the same encoder on the
    plain attention and in fp32; returns the flash launches of its
    step.

    The loss is held at phase 7's rtol 1e-3.  Each gradient is held to
    the fp32 encoder's: through the kernels it may lie at most
    NN_FLASH_RATIO times as far (relative L2) from the fp32 gradient as
    the plain bf16 path's, or as 2e-2 where that is nearer.  Where the
    plain bf16 gradient lies within 2e-2 of fp32, the kernels' is also
    held to the plain path's at phase 7's relative L2 2e-2.  (bf16 alone
    moves the deep layers' q / k projection gradients, which are small
    through a diffuse 2048-key softmax, up to 19% from fp32, and the
    kernels' rounding differs from the plain path's there; the kernels
    lay within 1.1 times the plain path's distance, measured.)
    Gradients that are zero in exact arithmetic (the key projections'
    biases: the softmax is invariant to them) are left out."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn.functional import attention as attn_mod
    nn = P.nn
    P.set_device("gpu")
    P.seed(1)
    enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        512, 8, 2048, dropout=0.0), 6)
    rs = np.random.RandomState(2)
    xv = rs.randn(NN_FLASH_B, NN_FLASH_S, 512).astype(np.float32)
    wv = rs.rand(NN_FLASH_B, NN_FLASH_S, 512).astype(np.float32)

    def loss_and_grads(bf16, kernel):
        enc.clear_gradients()
        x = P.to_tensor(xv, stop_gradient=False)
        real = attn_mod.flash_attention
        if not kernel:
            attn_mod.flash_attention = fa.flash_attention_ref
        try:
            with amp.auto_cast(enable=bf16, dtype="bfloat16"):
                out = enc(x)
            loss = P.mean(P.square(P.cast(out, "float32")
                                   - P.to_tensor(wv)))
            loss.backward()
        finally:
            attn_mod.flash_attention = real
        grads = {n: p.grad.torch().float().clone()
                 for n, p in enc.named_parameters()}
        grads["x"] = x.grad.torch().float().clone()
        return float(loss), grads

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    zero_flash_counts(fa)
    l_kernel, g_kernel = loss_and_grads(True, True)
    launches = flash_counts(fa)
    check(all(v == 6 for v in launches.values()),
          f"phase 25 (c): flash launches {launches}, 6 of each expected")
    l_plain, g_plain = loss_and_grads(True, False)
    l_f32, g_f32 = loss_and_grads(False, False)
    check(abs(l_kernel - l_plain) <= 1e-3 * abs(l_plain),
          f"phase 25 (c): loss through the kernels {l_kernel} vs plain "
          f"{l_plain}")
    biggest = max(float(g.norm()) for g in g_f32.values())
    worst_ratio, worst_near, worst_bf16, worst_kernel = 0.0, 0.0, 0.0, 0.0
    held, near = 0, 0
    for name, gp in g_plain.items():
        if float(g_f32[name].norm()) < 1e-6 * biggest:
            continue
        d_plain = rel(gp, g_f32[name])
        d_kernel = rel(g_kernel[name], g_f32[name])
        ratio = d_kernel / max(d_plain, 2e-2)
        check(ratio <= NN_FLASH_RATIO,
              f"phase 25 (c): gradient {name}: through the kernels "
              f"{d_kernel:.3e} from fp32 (relative L2), beyond "
              f"{NN_FLASH_RATIO} x max(2e-2, the plain bf16 path's "
              f"{d_plain:.3e})")
        if d_plain < 2e-2:
            err = rel(g_kernel[name], gp)
            check(err <= 2e-2,
                  f"phase 25 (c): gradient {name}: the kernels differ from "
                  f"the plain attention by relative L2 {err:.3e} > 2e-2 "
                  f"(the plain path {d_plain:.3e} from fp32)")
            worst_near, near = max(worst_near, err), near + 1
        worst_ratio = max(worst_ratio, ratio)
        worst_bf16 = max(worst_bf16, d_plain)
        worst_kernel = max(worst_kernel, d_kernel)
        held += 1
    print(f"phase 25 (c) Layer TransformerEncoder (d_model 512, 8 heads, 6 "
          f"layers, B={NN_FLASH_B}, S={NN_FLASH_S}, bf16 under auto_cast): "
          f"flash launches a step {launches}; loss {l_kernel:.6f} vs plain "
          f"{l_plain:.6f} (fp32 {l_f32:.6f}); {held} gradients, relative L2 "
          f"from fp32: kernels worst {worst_kernel:.3e}, plain bf16 worst "
          f"{worst_bf16:.3e}, worst kernels / max(2e-2, plain) "
          f"{worst_ratio:.3f} (limit {NN_FLASH_RATIO}); {near} gradients "
          f"with the plain path within 2e-2 of fp32: kernels vs plain worst "
          f"{worst_near:.3e} (limit 2e-2); loss rtol 1e-3 [{card}]",
          flush=True)
    del enc
    torch.cuda.empty_cache()
    return launches


def beam_record(decoder, inits, steps):
    """``dynamic_decode``'s search with ``decoder``, step by step, in the
    same arithmetic, recorded as numpy arrays: each step's ``tokens``,
    ``parents`` and ``scores`` ``[steps, B, beam]`` and ``member``
    ``[steps, B]``, the gap between the beam-th and the (beam + 1)-th
    candidate, which decides which hypotheses stay (inf where the
    (beam + 1)-th is not live)."""
    import numpy as np
    import torch
    tokens, states, log_probs, finished = decoder.initialize(inits)
    batch, beam = tokens.shape
    rec = {"tokens": [], "parents": [], "scores": [], "member": []}
    for _ in range(steps):
        logits, states = decoder.step(tokens.reshape(-1), states)
        vocab = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), -1).reshape(batch, beam,
                                                              vocab)
        fin = torch.full((vocab,), -1e9, device=logp.device)
        fin[decoder.end_token] = 0.0
        logp = torch.where(finished[:, :, None], fin, logp)
        total = (log_probs[:, :, None] + logp).reshape(batch, -1)
        log_probs, idx = torch.topk(total, beam, dim=-1)
        nxt = torch.topk(total, beam + 1, dim=-1).values[:, beam]
        member = torch.where(nxt > -1e8, log_probs[:, -1] - nxt,
                             torch.full_like(nxt, float("inf")))
        parents = torch.div(idx, vocab, rounding_mode="floor")
        tokens = idx % vocab
        gather = (torch.arange(batch, device=idx.device)[:, None] * beam
                  + parents).reshape(-1)
        states = [(h.index_select(0, gather), c.index_select(0, gather))
                  for h, c in states]
        finished = torch.gather(finished, 1, parents) | (
            tokens == decoder.end_token)
        for key, v in (("tokens", tokens), ("parents", parents),
                       ("scores", log_probs), ("member", member)):
            rec[key].append(v.cpu().numpy())
        if bool(finished.all()):
            break
    return {k: np.stack(v) for k, v in rec.items()}


def beam_prefixes(rec, step):
    """The hypotheses alive after ``step`` of a recorded search, each
    backtraced through its parents: ``[B, beam, step + 1]``."""
    import numpy as np
    tokens, parents = rec["tokens"], rec["parents"]
    idx = np.tile(np.arange(tokens.shape[2]), (tokens.shape[1], 1))
    out = []
    for t in range(step, -1, -1):
        out.append(np.take_along_axis(tokens[t], idx, 1))
        idx = np.take_along_axis(parents[t], idx, 1)
    return np.stack(out[::-1], -1)


def check_beams(ids, recs):
    """Phase 25 (d)'s check of the card's beam search against the CPU's.

    Each device's recorded search backtraces to its ``dynamic_decode``
    ids exactly.  A source meets a near tie at the first step whose gap
    between the beam-th and (beam + 1)-th candidate lies under
    NN_TIE_MARGIN on either device (there another device may keep
    another hypothesis), or, at the last step, whose best ``beam``
    candidates lie that close to each other (which orders the output).
    Before its first near tie, a source's hypotheses after every step
    are the CPU's, their scores within rtol NN_BEAM_RTOL; a source with
    none has the CPU's ids exactly and its final scores within
    NN_BEAM_RTOL.  Fails if every source meets a near tie.  Returns
    (sources held whole, {source: first near-tie step, the step count
    for a tie in the last step's order}, worst relative score
    difference)."""
    import numpy as np
    for dev, rec in recs.items():
        steps = rec["tokens"].shape[0]
        check(np.array_equal(beam_prefixes(rec, steps - 1), ids[dev]),
              f"phase 25 (d): the recorded search on the {dev} does not "
              f"backtrace to its dynamic_decode ids")
    gpu, cpu = recs["gpu"], recs["cpu"]
    check(gpu["tokens"].shape == cpu["tokens"].shape,
          f"phase 25 (d): {gpu['tokens'].shape[0]} search steps on the "
          f"card, {cpu['tokens'].shape[0]} on the CPU")
    steps, batch, _ = cpu["tokens"].shape
    member = np.minimum(gpu["member"], cpu["member"])
    last = np.minimum(*(np.where(r["scores"][-1, :, :-1] > -1e8,
                                 r["scores"][-1, :, :-1]
                                 - r["scores"][-1, :, 1:], np.inf).min(-1)
                        for r in (gpu, cpu)))
    whole, excused, worst = 0, {}, 0.0
    for b in range(batch):
        ties = np.nonzero(member[:, b] < NN_TIE_MARGIN)[0]
        first = int(ties[0]) if len(ties) else steps
        for t in range(first):
            hyp = {}
            for dev, rec in recs.items():
                seqs = beam_prefixes(rec, t)[b]
                hyp[dev] = dict(zip(map(tuple, seqs), rec["scores"][t, b]))
            check(set(hyp["gpu"]) == set(hyp["cpu"]),
                  f"phase 25 (d): source {b}: the card keeps other "
                  f"hypotheses than the CPU after step {t}, before any "
                  f"near tie (first at step {first})")
            for seq, want in hyp["cpu"].items():
                err = abs(hyp["gpu"][seq] - want) / max(1.0, abs(want))
                check(err <= NN_BEAM_RTOL,
                      f"phase 25 (d): source {b} step {t}: a hypothesis' "
                      f"score {hyp['gpu'][seq]} on the card vs {want}")
                worst = max(worst, float(err))
        if first < steps or last[b] < NN_TIE_MARGIN:
            excused[b] = first
            continue
        check(np.array_equal(ids["gpu"][b], ids["cpu"][b]),
              f"phase 25 (d): source {b} met no near tie, yet its beams "
              f"differ from the CPU's")
        whole += 1
    check(whole > 0, f"phase 25 (d): every source met a near tie "
          f"(first steps {excused}): nothing was held whole")
    return whole, excused, worst


def nn_lstm_phase(P, card):
    """(d): the LSTM encoder-decoder trained NN_RNN_STEPS steps at batch
    NN_RNN_B and length NN_RNN_T, then beam search on the card against
    the CPU on the same weights."""
    import numpy as np
    import torch
    _, Seq2SeqLSTM = nn_models(P)
    P.set_device("gpu")
    P.seed(3)
    model = Seq2SeqLSTM()
    rs = np.random.RandomState(3)
    src = P.to_tensor(rs.randint(3, NN_SRC_VOCAB, (NN_RNN_B, NN_RNN_T)))
    tgt = rs.randint(3, NN_TGT_VOCAB, (NN_RNN_B, NN_RNN_T + 1))
    y_in, y = P.to_tensor(tgt[:, :-1]), P.to_tensor(tgt[:, 1:])
    opt = P.optimizer.Adam(learning_rate=1e-3,
                           parameters=model.parameters(),
                           grad_clip=P.nn.ClipGradByGlobalNorm(5.0))
    ce = P.nn.CrossEntropyLoss()
    losses, times = [], []
    for _ in range(NN_RNN_STEPS):
        t0 = time.perf_counter()
        loss = ce(P.reshape(model(src, y_in), [-1, NN_TGT_VOCAB]),
                  P.reshape(y, [-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"phase 25 (d): LSTM losses {losses}")
    model.eval()
    # three steps leave the logits near uniform, where every search meets
    # near ties: the head's weights scaled by NN_HEAD_SCALE spread the
    # candidates as a trained model's do, on both devices alike
    with P.no_grad():
        model.output.weight.set_value(model.output.weight * NN_HEAD_SCALE)
    cpu = nn_cpu_copy(P, Seq2SeqLSTM, model).eval()
    srcs = rs.randint(3, NN_SRC_VOCAB, (NN_BEAM_SOURCES, NN_RNN_T))
    ids, recs, lens = {}, {}, {}
    for dev, m in (("gpu", model), ("cpu", cpu)):
        P.set_device(dev)
        dec = P.nn.BeamSearchDecoder(m.cell, start_token=1, end_token=2,
                                     beam_size=NN_BEAM,
                                     embedding_fn=m.tgt_embedding,
                                     output_fn=m.output)
        with P.no_grad():
            inits = m.encode(P.to_tensor(srcs))
            t0 = time.perf_counter()
            out, lens[dev] = P.nn.dynamic_decode(
                dec, inits=inits, max_step_num=NN_BEAM_STEPS,
                return_length=True)
            if dev == "gpu":
                torch.cuda.synchronize()
                beam_s = time.perf_counter() - t0
            recs[dev] = beam_record(dec, [tuple(t.torch() for t in s)
                                          for s in inits], NN_BEAM_STEPS)
        ids[dev] = out.numpy()
    P.set_device("gpu")
    whole, excused, worst = check_beams(ids, recs)
    held = [b for b in range(NN_BEAM_SOURCES) if b not in excused]
    check(np.array_equal(lens["gpu"].numpy()[held], lens["cpu"].numpy()[held]),
          "phase 25 (d): dynamic_decode's lengths differ from the CPU's")
    print(f"phase 25 (d) LSTM seq2seq (vocab {NN_SRC_VOCAB} -> "
          f"{NN_TGT_VOCAB}, width {NN_RNN_WIDTH}, {NN_RNN_LAYERS} layers, "
          f"B={NN_RNN_B}, T={NN_RNN_T}, Adam + ClipGradByGlobalNorm(5.0)): "
          f"losses " + " ".join(f"{v:.4f}" for v in losses)
          + f", {times[-1] * 1e3:.1f} ms a step; beam {NN_BEAM} over "
          f"{NN_BEAM_SOURCES} sources, {ids['gpu'].shape[-1]} steps in "
          f"{beam_s:.3f} s: {whole} sources equal the CPU's ids and final "
          f"scores with no near tie; {len(excused)} excused after a near "
          f"tie (gap < {NN_TIE_MARGIN}; first at steps "
          f"{sorted(excused.values())}), equal to the CPU before it; worst "
          f"relative score difference {worst:.3e} (limit {NN_BEAM_RTOL}) "
          f"[{card}]", flush=True)
    del model, cpu, opt
    gc.collect()
    torch.cuda.empty_cache()


def nn_sweep(P, C, card):
    """(e): every case of tests/torch_nn_cases.py on the card against the
    CPU, forward and gradient, every output on the card."""
    worst = {}
    t0 = time.perf_counter()
    for case in C.CASES:
        cid, fn, inputs, tol, grad, section = case
        P.set_device("gpu")
        outs = C.flat(fn(P, *[P.to_tensor(a) for a in inputs]))
        check(all(o.place.is_gpu_place() for o in outs),
              f"phase 25 (e): {cid} left the card")
        for g in ((False, True) if grad else (False,)):
            P.set_device("cpu")
            want = C.run_case(P, case, g)
            P.set_device("gpu")
            got = C.run_case(P, case, g)
            err = 0.0
            for k, (a, b) in enumerate(zip(got[0], want[0])):
                err = max(err, C.compare(a, b, tol,
                                         f"phase 25 (e) {cid} output {k}"))
            if g:
                err = max(err, C.compare_grads(got[1], want[1], tol,
                                               f"phase 25 (e) {cid}"))
            worst[section] = max(worst.get(section, 0.0), err)
    print(f"phase 25 (e) nn sweep: {len(C.CASES)} cases on the card equal "
          f"the CPU, forward and gradient; worst abs error by section: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f" ({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)


def nn_phase(card, fa):
    """Phase 25: the Paddle nn layer system on the card (see the module
    docstring); returns (c)'s flash launches."""
    import paddle_tpu_torch as P
    nn_transformer_phase(P, card)
    launches = nn_flash_phase(P, fa, card)
    nn_lstm_phase(P, card)
    nn_sweep(P, tests_module("torch_nn_cases"), card)
    P.set_device("gpu")
    return launches


# -- phase 26 -------------------------------------------------------------
# (a): BASELINE.md config 3, BERT-base fine-tuned through hapi.Model on a
# synthetic SST-2: single sentences, lengths lognormal around a median of
# 24 tokens (clipped to 4-128), ids uniform over the vocabulary past the
# specials, class-1 rows carrying a marker token
HAPI_TRAIN, HAPI_EVAL = 2048, 512
HAPI_B, HAPI_ITERS = 32, 48
HAPI_BUCKETS = (32, 64, 128)
HAPI_MEDIAN, HAPI_SIGMA = 24, 0.6
HAPI_MARKER, HAPI_FIRST_ID = 999, 1000
HAPI_SEED = 1234                   # numpy data and paddle.seed alike
HAPI_PROFILE_STEPS = 4
HAPI_TIMED = 8                     # fit and hand-loop steps timed
HAPI_BATCH_BYTES = 8 * HAPI_B      # the smallest batch array: 32 labels
HAPI_RTOL = 1e-5                   # fit's losses against the hand loop
HAPI_CKPT_RTOL = 1e-6              # a resumed train_batch's loss
# (b): the sequence functionals over phase 24's ragged batch at width 768
SEQ_DIM = 768
SEQ_CONV_OUT = 256
SEQ_TOL = (1e-5, 1e-5)             # rtol, atol against the CPU
# (c): Criteo's dense part (13 integer counts and a label), 4 files
DS_FILES, DS_RECORDS, DS_BATCH, DS_THREADS = 4, 65536, 512, 4
RATES = {}                         # phase 20 (c) samples/s, when it ran


def shm_segments():
    """The /dev/shm segments this process's loaders may leave: its worker
    pools' (named ``ptq<pid>x...``, ``io/worker.py``) and Python's
    default-named ones (``psm_``)."""
    return {n for n in os.listdir("/dev/shm")
            if n.startswith((f"ptq{os.getpid()}x", "psm_"))}


def sst2_like(n, rs):
    """``n`` (ids, label) samples: lognormal lengths, uniform ids past the
    specials, a marker token first in every class-1 row."""
    import numpy as np
    lens = np.clip(np.round(rs.lognormal(np.log(HAPI_MEDIAN), HAPI_SIGMA,
                                         n)), 4, HAPI_BUCKETS[-1])
    labels = rs.randint(0, 2, n)
    out = []
    for L, y in zip(lens.astype(int), labels):
        ids = rs.randint(HAPI_FIRST_ID, 30522, L).astype(np.int64)
        if y:
            ids[0] = HAPI_MARKER
        out.append((ids, np.int64(y)))
    return out


class ListDataset:
    def __init__(self, samples):
        self.samples = samples

    def __getitem__(self, i):
        return self.samples[i]

    def __len__(self):
        return len(self.samples)


def ids_and_labels(samples):
    """``bucketed_collate`` without its lengths column: the mask comes
    from the pad id, and Model's loss takes (logits, labels)."""
    from paddle_tpu_torch.io import bucketed_collate
    return bucketed_collate(buckets=HAPI_BUCKETS)(samples)[:2]


def padded_bert():
    """BERT-base behind a wrapper that takes padded ids: the mask from pad
    id 0, token type 0 (``Model`` sees one input and one label)."""
    import torch
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         BertModel)

    class PaddedBert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.clf = BertForSequenceClassification(
                BertModel.from_config("bert-base", seed=0), 2)

        def forward(self, ids):
            return self.clf(ids, torch.zeros_like(ids), (ids != 0).long())

    torch.manual_seed(0)   # the classifier head draws from torch's seed
    return PaddedBert()


def bert_recipe(P, net):
    opt = P.optimizer.AdamW(learning_rate=BERT_LR, weight_decay=0.01,
                            parameters=net.parameters())
    return opt, P.nn.CrossEntropyLoss()


def hapi_model(P):
    net = padded_bert()
    opt, loss = bert_recipe(P, net)
    return P.Model(net).prepare(opt, loss, metrics=P.metric.Accuracy(),
                                amp_configs={"level": "O1"})


def hapi_loader(P, ds, workers, shuffle=True, drop_last=True):
    sampler = P.io.BucketedBatchSampler(ds, batch_size=HAPI_B,
                                        buckets=HAPI_BUCKETS,
                                        shuffle=shuffle, drop_last=drop_last)
    return P.io.DataLoader(ds, batch_sampler=sampler,
                           collate_fn=ids_and_labels, num_workers=workers,
                           timeout=300)


def upload_streams(prof_dir):
    """From a profiler trace: the host-to-device copies (name, stream,
    bytes) and the stream most of the kernels ran on."""
    import collections
    with open(os.path.join(prof_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    copies = [(e["name"], e.get("args", {}).get("stream"),
               e.get("args", {}).get("bytes", HAPI_BATCH_BYTES))
              for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = collections.Counter(e.get("args", {}).get("stream")
                                  for e in events
                                  if e.get("cat") == "kernel")
    return copies, kernels.most_common(1)[0][0] if kernels else None


def hapi_bert_phase(P, card):
    """(a): BERT-base fine-tuned through ``hapi.Model`` (the module
    docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import csrc
    shm_before = shm_segments()
    laps = [("start", time.perf_counter())]
    rs = np.random.RandomState(HAPI_SEED)
    train = ListDataset(sst2_like(HAPI_TRAIN, rs))
    evals = ListDataset(sst2_like(HAPI_EVAL, rs))
    # the batches of two workers equal those of none, in order
    P.seed(HAPI_SEED)
    plain = list(hapi_loader(P, train, 0).host_batches())
    P.seed(HAPI_SEED)
    mp_loader = hapi_loader(P, train, 2)
    mp_iter = mp_loader.host_batches()
    check(isinstance(mp_iter.mp_it.order, csrc.NativeOrderedQueue),
          "phase 26 (a): the workers' batches bypass the native queue")
    workers = [next(mp_iter)]
    # the leak check at the end can see the workers' segments: batches
    # wait in them while the iterator is live
    deadline = time.perf_counter() + 5
    while not shm_segments() - shm_before and \
            time.perf_counter() < deadline:
        time.sleep(0.01)
    live = len(shm_segments() - shm_before)
    check(live, "phase 26 (a): no segment of the workers in /dev/shm "
          "while they run")
    workers += list(mp_iter)
    del mp_iter
    check(len(workers) == len(plain) and all(
        all(a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(w, p)) for w, p in zip(workers, plain)),
        "phase 26 (a): num_workers=2 batches differ from num_workers=0's")
    shapes = sorted({tuple(b[0].shape) for b in plain})
    laps.append(("batches", time.perf_counter()))
    # fit, then the hand loop of the same recipe over the same batches
    model = hapi_model(P)
    losses = []

    class Losses(P.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    # both runs under torch's deterministic algorithms (cuBLAS's
    # workspace is set in main, before the card's first call): the
    # embeddings' backward (index_add_) otherwise sums with atomics, in
    # an order that changes from run to run, and AdamW lifts that noise
    # in near-zero gradients to steps of the learning rate.  An op with
    # no deterministic form raises and fails the phase.
    torch.use_deterministic_algorithms(True)
    try:
        P.seed(HAPI_SEED)
        model.fit(hapi_loader(P, train, 2), epochs=1, num_iters=HAPI_ITERS,
                  verbose=0, callbacks=[Losses()])
        hand_net = padded_bert()
        opt, loss_fn = bert_recipe(P, hand_net)
        step = P.parallel.TrainStep(hand_net, opt, loss_fn=loss_fn,
                                    amp_level="O1")
        laps.append(("fit", time.perf_counter()))
        P.seed(HAPI_SEED)
        hand = [float(step.step([x], [y])) for x, y in plain[:HAPI_ITERS]]
        laps.append(("hand loop", time.perf_counter()))
    finally:
        torch.use_deterministic_algorithms(False)
    # the rates in torch's default mode, the one users train in: fit, then
    # the hand loop, over the same first batches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    P.seed(HAPI_SEED)
    t0 = time.perf_counter()
    model.fit(hapi_loader(P, train, 2), epochs=1, num_iters=HAPI_TIMED,
              verbose=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    waits, steps = list(model.fit_wait_ms), list(model.fit_step_ms)
    t0 = time.perf_counter()
    hand_ms = []
    for x, y in plain[:HAPI_TIMED]:
        t1 = time.perf_counter()
        float(step.step([x], [y]))
        hand_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    hand_s = time.perf_counter() - t0
    laps.append(("timed fit and hand loop", time.perf_counter()))
    del step, opt, hand_net
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, hand))
    check(len(losses) == HAPI_ITERS and rel <= HAPI_RTOL,
          f"phase 26 (a): fit's losses differ from the hand loop's by "
          f"{rel:.3g} relative ({len(losses)} steps): fit "
          + " ".join(f"{v:.6f}" for v in losses[:6]) + " hand "
          + " ".join(f"{v:.6f}" for v in hand[:6]))
    # evaluate against predict
    laps.append(("compare", time.perf_counter()))
    P.seed(HAPI_SEED)
    eval_loader = hapi_loader(P, evals, 0, shuffle=False, drop_last=False)
    order = [i for b in eval_loader.batch_sampler for i in b]
    labels = np.array([evals[i][1] for i in order])
    logs = model.evaluate(eval_loader, verbose=0)
    logits = model.predict(eval_loader)[0]
    flat = np.concatenate(logits)
    acc = float((flat.argmax(-1) == labels).mean())
    per_batch, off = [], 0
    for lg in logits:
        z = lg.astype(np.float64)
        lse = np.log(np.exp(z - z.max(-1, keepdims=True)).sum(-1)) + \
            z.max(-1)
        per_batch.append(float(np.mean(lse - z[np.arange(len(z)),
                                                labels[off:off + len(z)]])))
        off += len(z)
    ce = float(np.mean(per_batch))
    check(logs["acc"] == acc, f"phase 26 (a): evaluate's accuracy "
          f"{logs['acc']} is not predict's argmax {acc}")
    check(abs(logs["loss"] - ce) <= 1e-6 * abs(ce),
          f"phase 26 (a): evaluate's loss {logs['loss']} is not predict's "
          f"CE {ce}")
    # the checkpoint: logits bit-identical, the optimizer state back
    laps.append(("evaluate, predict", time.perf_counter()))
    ckpt = os.path.join(HERE, "build", "phase26_ckpt", "bert")
    model.save(ckpt)
    fresh = hapi_model(P)
    fresh.load(ckpt)
    again = np.concatenate(fresh.predict(eval_loader)[0])
    check(np.array_equal(again, flat), "phase 26 (a): the loaded model's "
          "logits differ from the saved model's")
    # the second step's loss follows the first step's update, which the
    # optimizer's restored moments and step count shape
    resumed = []
    for m in (model, fresh):
        P.seed(HAPI_SEED + 1)
        resumed.append([m.train_batch([x], [y])[0]
                        for x, y in plain[HAPI_ITERS:HAPI_ITERS + 2]])
    (a0, a), (b0, b) = resumed
    check(abs(a0 - b0) <= HAPI_CKPT_RTOL * abs(a0) and
          abs(a - b) <= HAPI_CKPT_RTOL * abs(a), f"phase 26 (a): the "
          f"resumed train_batch losses {resumed[1]} are not the "
          f"original's {resumed[0]}")
    shutil.rmtree(os.path.dirname(ckpt))
    del fresh
    # uploads: pinned copies on the DeviceLoader's stream, not the step's
    laps.append(("checkpoint", time.perf_counter()))
    prof_dir = os.path.join(HERE, "build", "phase26_profile")
    os.makedirs(prof_dir, exist_ok=True)
    P.seed(HAPI_SEED)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.fit(hapi_loader(P, train, 2), epochs=1,
                  num_iters=HAPI_PROFILE_STEPS, verbose=0)
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
    copies, step_stream = upload_streams(prof_dir)
    shutil.rmtree(prof_dir)
    # every batch-sized upload in the window is pinned and off the
    # step's stream (the trace may drop a few events at its start: at
    # least one batch's two arrays must show); smaller copies are the
    # ops' own scalars
    batch = [(n, s) for n, s, b in copies if b >= HAPI_BATCH_BYTES]
    pinned = [s for n, s in batch if "Pinned" in n and s != step_stream]
    check(len(pinned) >= 2 and len(pinned) == len(batch),
          f"phase 26 (a): {len(pinned)} of {len(batch)} batch uploads "
          f"pinned and off the step's stream {step_stream} in "
          f"{HAPI_PROFILE_STEPS} fit steps (host-to-device copies: "
          f"{sorted(set(copies))})")
    laps.append(("profile", time.perf_counter()))
    with contextlib.redirect_stdout(io_mod.StringIO()):
        summary = model.summary(input_size=(HAPI_B, HAPI_BUCKETS[-1]),
                                dtype="int64")
    flops = model.flops(input_size=(HAPI_B, HAPI_BUCKETS[-1]),
                        dtype="int64")
    del model
    gc.collect()
    laps.append(("summary, flops", time.perf_counter()))
    leaked = shm_segments() - shm_before
    check(not leaked, f"phase 26 (a): shared-memory segments left behind: "
          f"{sorted(leaked)[:5]}")
    sps = HAPI_B * HAPI_TIMED / fit_s
    hand_sps = HAPI_B * HAPI_TIMED / hand_s
    # past the first step (the workers' start): a fit step with its
    # wait, metrics and callbacks
    steady = HAPI_B * (HAPI_TIMED - 1) * 1e3 / sum(steps[1:])
    hand_steady = HAPI_B * (HAPI_TIMED - 1) * 1e3 / sum(hand_ms[1:])
    p20 = RATES.get("bert")
    print(f"phase 26 (a) BERT-base through hapi.Model, O1, B {HAPI_B}, "
          f"buckets {HAPI_BUCKETS} (batch shapes {shapes}), "
          f"{HAPI_ITERS} fit steps: host library {csrc.load().path}; "
          f"workers' batches equal num_workers=0's ({len(plain)}); losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, fit vs hand loop max rel "
          f"{rel:.3g}; eval acc {acc:.4f} loss {ce:.6f}; checkpoint "
          f"logits bit-identical, resumed loss rel "
          f"{abs(a - b) / abs(a):.3g}; in torch's default mode, "
          f"{HAPI_TIMED} steps: fit samples_per_s {sps:.1f} "
          f"(steady {steady:.1f}; the hand loop {hand_sps:.1f}, steady "
          f"{hand_steady:.1f}, ratio {steady / hand_steady:.3f}; phase 20 "
          "(c) " + (f"{p20:.1f} at S 128, ratio {steady / p20:.3f}" if p20
                    else "not run") + f"); next(feed) wait ms p50 "
          f"{float(np.median(waits)):.3f} max {max(waits):.3f} against a "
          f"step's ms p50 {float(np.median(steps)):.3f}; peak_mem_gb "
          f"{peak_gb:.2f}; batch uploads in a {HAPI_PROFILE_STEPS}-step "
          f"window: {len(pinned)} traced, all pinned, on stream(s) "
          f"{sorted(set(pinned))} vs the step's {step_stream}; summary "
          f"params {summary['total_params']} flops at ({HAPI_B}, "
          f"{HAPI_BUCKETS[-1]}) {flops}; /dev/shm: {live} workers' "
          "segments while the first loader ran, none left after; s by "
          "part: " + ", ".join(f"{n} {t - p:.1f}" for (_, p), (n, t) in
                               zip(laps, laps[1:])) + f" [{card}]",
          flush=True)


def sequence_inputs(np, rs, lens):
    """The ragged batch padded to [64, 2048, 768] (uniform in [0, 1):
    sums of positive terms) and what the functionals take beside it."""
    B, T, D = len(lens), max(lens), SEQ_DIM
    ln = np.array(lens, np.int64)
    x = rs.rand(B, T, D).astype(np.float32)
    valid = np.arange(T)[None] < ln[:, None]
    return dict(
        x=x * valid[..., None], lens=ln, flat=x[valid],
        scores=rs.rand(B, T).astype(np.float32),
        rows=rs.rand(B, D).astype(np.float32),
        other=rs.rand(B, 128, D).astype(np.float32),
        other_lens=rs.randint(0, 129, B).astype(np.int64),
        ids=rs.randint(1, 50, (B, T)).astype(np.int64),
        ref=rs.randint(1, 50, (B, T)).astype(np.int64),
        offset=rs.randint(0, 64, B).astype(np.int64),
        length=rs.randint(1, 512, B).astype(np.int64),
        index=rs.randint(0, T, (B, 16)).astype(np.int64),
        updates=rs.rand(B, 16, D).astype(np.float32),
        row_w=rs.rand(3, D).astype(np.float32),
        conv_w=(rs.rand(3 * D, SEQ_CONV_OUT) / D).astype(np.float32),
        conv_b=rs.rand(SEQ_CONV_OUT).astype(np.float32),
        match=rs.rand(B, 4, 32, T).astype(np.float32),
        match_rows=np.minimum(ln, 32))


SEQ_CASES = {
    # name: (fn(F, t), names of the float inputs whose gradients count)
    "sequence_pad": (lambda F, t: F.sequence_pad(t["flat"], 0.0,
                                                 lengths=t["lens"]), ()),
    "sequence_unpad": (lambda F, t: F.sequence_unpad(t["x"], t["lens"]),
                       ()),
    **{f"sequence_pool_{p}": ((lambda p: lambda F, t: F.sequence_pool(
        t["x"], p, t["lens"]))(p), ("x",))
       for p in ("sum", "average", "sqrt", "max", "min", "first", "last")},
    "sequence_softmax": (lambda F, t: F.sequence_softmax(t["scores"],
                                                         t["lens"]),
                         ("scores",)),
    "sequence_expand": (lambda F, t: F.sequence_expand(t["rows"],
                                                       t["lens"]), ()),
    "sequence_reverse": (lambda F, t: F.sequence_reverse(t["x"],
                                                         t["lens"]), ()),
    "edit_distance": (lambda F, t: F.edit_distance(
        t["ids"], t["ref"], normalized=False, input_length=t["lens"],
        label_length=t["lens"]), ()),
    "row_conv": (lambda F, t: F.row_conv(t["x"], t["row_w"]), ()),
    "sequence_first_step": (lambda F, t: F.sequence_first_step(
        t["x"], t["lens"]), ()),
    "sequence_last_step": (lambda F, t: F.sequence_last_step(
        t["x"], t["lens"]), ()),
    "sequence_concat": (lambda F, t: F.sequence_concat(
        [t["x"], t["other"]], [t["lens"], t["other_lens"]]), ()),
    "sequence_expand_as": (lambda F, t: F.sequence_expand_as(
        t["rows"], t["lens"]), ()),
    "sequence_slice": (lambda F, t: F.sequence_slice(
        t["x"], t["offset"], t["length"]), ()),
    "sequence_scatter": (lambda F, t: F.sequence_scatter(
        t["x"], t["index"], t["updates"], t["lens"] * 0 + 16), ()),
    "sequence_enumerate": (lambda F, t: F.sequence_enumerate(
        t["ids"], 3, lengths=t["lens"]), ()),
    "sequence_reshape": (lambda F, t: F.sequence_reshape(
        t["x"], SEQ_DIM // 2, t["lens"]), ()),
    "sequence_conv": (lambda F, t: F.sequence_conv(
        t["x"], t["conv_w"], t["conv_b"], lengths=t["lens"]),
        ("x", "conv_w", "conv_b")),
    "sequence_erase": (lambda F, t: F.sequence_erase(
        t["ids"], [1, 2, 3], lengths=t["lens"]), ()),
    "sequence_topk_avg_pooling": (
        lambda F, t: F.sequence_topk_avg_pooling(
            t["match"], t["match_rows"], t["lens"], topks=[1, 3, 10],
            channel_num=4), ()),
}


def run_sequence_case(P, torch, np, fn, grads, arrays, base, dev):
    """Outputs and the named gradients of ``sum(out * w)`` (w uniform, from
    a seed) on ``dev``, as torch tensors; ``base`` holds the inputs on
    ``dev``."""
    P.set_device(dev)
    ts = dict(base)
    ts.update({k: P.to_tensor(arrays[k], stop_gradient=False)
               for k in grads})
    out = fn(P.nn.functional, ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    got = [o.torch().detach() for o in outs]
    if grads:
        loss = 0.0
        for k, o in enumerate(outs):
            if o.torch().requires_grad:
                w = torch.from_numpy(np.random.RandomState(k).rand(
                    *o.shape).astype(np.float32)).to(o.torch().device)
                loss = loss + (o.torch() * w).sum()
        loss.backward()
        got += [ts[k].grad.torch() for k in grads]
    return got, ts, outs


def sequence_phase(P, card):
    """(b): every public function of ``nn/functional/sequence.py`` on the
    card against the CPU over phase 24's ragged batch at width 768."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core import ragged as R
    import paddle_tpu_torch.nn.functional.sequence as S
    lens = ragged_lengths()
    arrays = sequence_inputs(np, np.random.RandomState(3), lens)
    public = {n for n in dir(S) if not n.startswith("_") and callable(
        getattr(S, n)) and getattr(getattr(S, n), "__module__", "") ==
        S.__name__}
    ran = {n.split("_pool_")[0] + ("_pool" if "_pool_" in n else "")
           for n in SEQ_CASES}
    check(public <= ran, f"phase 26 (b): functions not run: "
          f"{sorted(public - ran)}")
    base = {}
    for dev in ("cpu", "gpu"):
        P.set_device(dev)
        base[dev] = {k: P.to_tensor(v) for k, v in arrays.items()}
    worst, times, spent = {}, {}, {"cpu": 0.0, "card": 0.0}
    for name, (fn, grads) in SEQ_CASES.items():
        t0 = time.perf_counter()
        cpu, _, _ = run_sequence_case(P, torch, np, fn, grads, arrays,
                                      base["cpu"], "cpu")
        t1 = time.perf_counter()
        gpu, ts, outs = run_sequence_case(P, torch, np, fn, grads, arrays,
                                          base["gpu"], "gpu")
        torch.cuda.synchronize()
        spent["cpu"] += t1 - t0
        spent["card"] += time.perf_counter() - t1
        check(all(o.place.is_gpu_place() for o in outs),
              f"phase 26 (b) {name}: an output off the card")
        err = 0.0
        for a, b in zip(gpu, cpu):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"phase 26 (b) {name}: {a.shape} {a.dtype} against the "
                  f"CPU's {b.shape} {b.dtype}")
            b = b.to(a.device)          # compared on the card
            if a.is_floating_point():
                check(bool(torch.isclose(a, b, rtol=SEQ_TOL[0],
                                         atol=SEQ_TOL[1]).all()),
                      f"phase 26 (b) {name}: the card differs from the CPU "
                      f"by {float((a - b).abs().max()):.3g}")
                err = max(err, float((a - b).abs().max()))
            else:
                check(bool(torch.equal(a, b)), f"phase 26 (b) {name}: "
                      "integer outputs differ from the CPU's")
        worst[name] = err
        del cpu, gpu
        with torch.no_grad():
            # the dynamic programme runs 2048 host-driven steps a call
            slow = name == "edit_distance"
            times[name] = cuda_time_ms(
                lambda: fn(P.nn.functional, ts), iters=1 if slow else 5,
                warmup=0 if slow else 1)
    # the RaggedTensor routes of the same functions
    rt = R.RaggedTensor.from_rows(
        [arrays["flat"][a:b] for a, b in zip(
            np.cumsum([0] + lens[:-1]), np.cumsum(lens))],
        capacity=RAGGED_CAPACITY)
    got = {}
    for dev in ("cpu", "gpu"):
        P.set_device(dev)
        r = R.RaggedTensor(P.to_tensor(rt.values.numpy()),
                           P.to_tensor(rt.row_splits.numpy()))
        got[dev] = [P.nn.functional.sequence_pool(r, "sum").numpy(),
                    P.nn.functional.sequence_reverse(r).values.numpy(),
                    P.nn.functional.sequence_pad(r, 0.0)[0].numpy()]
    for a, b in zip(got["gpu"], got["cpu"]):
        check(np.allclose(a, b, rtol=SEQ_TOL[0], atol=SEQ_TOL[1]),
              "phase 26 (b): a RaggedTensor route differs from the CPU")
    P.set_device("gpu")
    print(f"phase 26 (b) sequence functionals: {len(lens)} rows, "
          f"{sum(lens)} tokens (max {max(lens)}), width {SEQ_DIM}, fp32: "
          f"{len(public)} public functions ({len(SEQ_CASES)} cases, "
          "gradients of every pool type, softmax and conv) equal the CPU "
          f"at rtol {SEQ_TOL[0]} / atol {SEQ_TOL[1]} (integers exactly), "
          f"the RaggedTensor routes too (the CPU's runs {spent['cpu']:.1f} "
          f"s, the card's {spent['card']:.1f} s); ms a call / worst abs "
          "error: "
          + ", ".join(f"{k} {times[k]:.3f}/{worst[k]:.3g}" for k in
                      SEQ_CASES) + f" [{card}]", flush=True)


def dataset_phase(P, card):
    """(c): the native dataset engine over four part files of Criteo's
    dense part, against the pure-Python engine."""
    import numpy as np
    import torch
    root = os.path.join(HERE, "build", "phase26_criteo")
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(0)
    files = []
    for k in range(DS_FILES):
        dense = np.floor(rs.lognormal(1.5, 1.5, (DS_RECORDS, 13)))
        label = (rs.rand(DS_RECORDS, 1) < 0.25).astype(np.float64)
        path = os.path.join(root, f"part-{k}.txt")
        np.savetxt(path, np.concatenate([dense, label], 1), fmt="%d")
        files.append(path)

    class Var:
        def __init__(self, name, shape):
            self.name, self.shape, self.dtype = name, shape, "float32"

    def dataset(engine):
        ds = P.io.InMemoryDataset(engine=engine)
        ds.set_filelist(files)
        ds.set_use_var([Var("dense", [-1, 13]), Var("label", [-1, 1])])
        ds.set_batch_size(DS_BATCH)
        ds.set_thread(DS_THREADS)
        return ds

    nat = dataset("native")
    t0 = time.perf_counter()
    n = nat.load_into_memory()
    load_s = time.perf_counter() - t0
    nat.local_shuffle()
    feed = P.io.DeviceLoader(nat, buffer_size=2, wrap=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = [torch.cat([x, y], 1) for x, y in feed]
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    check(all(t.is_cuda for t in on_card), "phase 26 (c): a batch off the "
          "card")
    got = torch.cat(on_card).cpu().numpy()
    py = dataset("python")
    t0 = time.perf_counter()
    py.load_into_memory()
    py_s = time.perf_counter() - t0
    want = np.concatenate([np.concatenate(b, 1) for b in py])

    def rows(m):
        return m[np.lexsort(m.T[::-1])]

    total = DS_FILES * DS_RECORDS
    check(n == total and len(got) == total - total % DS_BATCH,
          f"phase 26 (c): {n} records loaded, {len(got)} walked, of "
          f"{total}")
    check(np.array_equal(rows(got), rows(want)), "phase 26 (c): the native "
          "engine's records differ from the pure-Python engine's")
    shutil.rmtree(root)
    print(f"phase 26 (c) native dataset engine: {DS_FILES} files x "
          f"{DS_RECORDS} records of 13 dense counts and a label, "
          f"{DS_THREADS} threads: load {n / load_s:.0f} records/s "
          f"({load_s:.3f} s; the Python engine {n / py_s:.0f}), "
          f"local_shuffle, {len(on_card)} batches of {DS_BATCH} through "
          f"DeviceLoader {len(got) / walk_s:.0f} records/s; the records "
          f"equal the Python engine's as a multiset, none lost [{card}]",
          flush=True)


def hapi_phase(card):
    """Phase 26: the data pipeline and the high-level API on the card (see
    the module docstring)."""
    import paddle_tpu_torch as P
    P.set_device("gpu")
    t0 = time.perf_counter()
    hapi_bert_phase(P, card)
    t1 = time.perf_counter()
    sequence_phase(P, card)
    t2 = time.perf_counter()
    dataset_phase(P, card)
    print(f"phase 26 parts: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
          f"(c) {time.perf_counter() - t2:.1f} s", flush=True)
    P.set_device("gpu")


def host_paths_of(root, card):
    """Phases 4 and 20 (a), (c) as the checkout at ``root`` runs them:
    its ``chip_smoke.py`` over its package (``--host-paths-of``)."""
    import importlib.util
    import torch
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_at_root", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attn as ragged_mod
    check(os.path.abspath(_build.__file__).startswith(root + os.sep),
          f"--host-paths-of: the package came from {_build.__file__}")
    print(f"host paths of {root}", flush=True)
    _build.load("ragged_paged_attn")
    _, model, reqs, _, fp_tps = cs.slice_phase(card, ragged_mod)
    host_profile(cs, model, reqs, card)
    del model
    model, _ = cs.moe_serve_phase(card, ragged_mod, reqs, fp_tps)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cs.bert_phase(card, fa, ragged_mod)


def host_profile(cs, model, reqs, card, top=12):
    """Phase 4's serve once more under cProfile: Python calls and
    profiled host time a tick, and the functions with the most own time
    (``--host-paths-of``)."""
    import cProfile
    import pstats
    import torch
    from paddle_tpu_torch.serving import Engine
    eng, _ = cs.submit_all(model, reqs, Engine)
    prof = cProfile.Profile()
    prof.enable()
    eng.run_until_idle()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    n = eng.ticks
    print(f"host profile: {stats.total_calls / n:.1f} Python calls a tick, "
          f"{stats.total_tt / n * 1e3:.3f} ms profiled host time a tick "
          f"over {n} ticks [{card}]", flush=True)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    for (path, line, name), (_, calls, own, _, _) in rows:
        where = path.split("paddle_tpu_torch")[-1] if "paddle_tpu_torch" \
            in path else os.path.basename(path)
        print(f"host profile fn: {own / n * 1e3:.4f} ms {calls / n:.1f} "
              f"calls a tick {where}:{line}({name})", flush=True)


def host_ab(parent, card):
    """``--host-ab PARENT``: ``host_paths_of`` the checkout at PARENT and
    of this one, each in a process of its own, in the order PARENT,
    this, this, PARENT; then ``wrapper_cost``."""
    import subprocess
    for root in (parent, HERE, HERE, parent):
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--host-paths-of", root])
        check(rc == 0, f"--host-ab: the run of {root} exited {rc}")
    wrapper_cost(card)


WRAPPER_CALLS, WRAPPER_ROUNDS = 2000, 5


def wrapper_cost(card):
    """The host time a call that ``nn.functional._io.api`` adds to a
    functional called with torch tensors, as the models call them:
    ``gelu``, ``linear`` and ``layer_norm`` at gpt2-medium's width on 8
    rows, each called WRAPPER_CALLS times through the wrapper and
    through its ``raw_fn`` in turn, WRAPPER_ROUNDS rounds; the medians,
    in us a call."""
    import statistics
    import torch
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 1024, device="cuda", generator=g)
    w = torch.randn(1024, 4096, device="cuda", generator=g)
    b = torch.randn(4096, device="cuda", generator=g)
    ones, zeros = torch.ones(1024, device="cuda"), torch.zeros(
        1024, device="cuda")
    calls = {"gelu": (F.gelu, (x,)), "linear": (F.linear, (x, w, b)),
             "layer_norm": (F.layer_norm, (x, [1024], ones, zeros))}
    for name, (fn, args) in calls.items():
        times = {"wrapped": [], "raw": []}
        for _ in range(WRAPPER_ROUNDS):
            for kind, f in (("wrapped", fn), ("raw", fn.raw_fn)):
                f(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(WRAPPER_CALLS):
                    f(*args)
                torch.cuda.synchronize()
                times[kind].append((time.perf_counter() - t0)
                                   / WRAPPER_CALLS * 1e6)
        wrapped, raw = (statistics.median(times[k]) for k in
                        ("wrapped", "raw"))
        print(f"wrapper cost {name}: {wrapped:.2f} us a call through "
              f"api, {raw:.2f} us through raw_fn, {wrapped - raw:.2f} us "
              f"added (medians of {WRAPPER_ROUNDS} rounds of "
              f"{WRAPPER_CALLS} calls) [{card}]", flush=True)


def finish_line(card):
    """The card line and the last line; returns the exit code 0."""
    import torch
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv):
    # cuBLAS's deterministic workspace, for phase 26 (a)'s deterministic
    # runs: read when the card's first cuBLAS handle is made, so set
    # before it.  On Hopper it is torch's default size (8 x 4 MiB).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    if "--tensor-layer" in argv:
        tensor_layer_phase(card)
        print(f"phase 24 (the Paddle tensor layer) done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return finish_line(card)

    if "--host-ab" in argv:
        host_ab(argv[argv.index("--host-ab") + 1], card)
        return finish_line(card)
    if "--host-paths-of" in argv:
        host_paths_of(argv[argv.index("--host-paths-of") + 1], card)
        return finish_line(card)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import ragged_paged_attn as ragged_mod
    if "--hapi" in argv:
        zero_flash_counts(fa)
        zero_ragged_counts(ragged_mod)
        hapi_phase(card)
        check(sum(flash_counts(fa).values()) == 0 and
              sum(ragged_counts(ragged_mod).values()) == 0,
              "phase 26 launched a kernel")
        print(f"phase 26 (the data pipeline and the high-level API) done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return finish_line(card)
    if "--nn" in argv:
        for name in ("flash_attention_sm90", "flash_attention"):
            _build.load(name)
        nn_phase(card, fa)
        print(f"phase 25 (the nn layer system) done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return finish_line(card)
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
        return finish_line(card)
    if "--profile-mesh" in argv:
        profile_mesh_phase(card)
        lap("mesh profile")
        return finish_line(card)
    if "--stage3" in argv:
        stage3_phase(card, fa)
        lap("stage 3 with and without recompute")
        return finish_line(card)
    if cards == 4:
        four_card_phase(card, ragged_mod)
        lap("four-card mesh")
        return finish_line(card)
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
    b1, xla_outs = xla_phase(card, ragged_mod, fa, model_fp, reqs, fp_outs)
    launches += b1
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
    b4, b1 = mesh_serving_phase(card, ragged_mod, fa, model_fp, reqs,
                                fp_outs, xla_outs, w_outs)
    mesh_launches += b4
    launches += b1
    check(sum(flash_counts(fa).values()) == 0,
          "phase 22 launched a flash kernel")
    lap("22 (the rest of serving over the mesh, batch norm over dp2)")
    del model_fp, model_q
    # a host-tier engine is a reference cycle (its prefix cache's evict
    # hook is a bound method of it): collect phase 17's before the
    # training phase measures its peak memory
    gc.collect()
    torch.cuda.empty_cache()
    bucket_fwd = bucket_phase(card, ragged_mod, fa)
    lap("16 (f) (bucketed prefill)")
    zero_ragged_counts(ragged_mod)
    flash_launches, phase6_tps = train_phase(card, fa)
    flash_launches["fwd"] += bucket_fwd
    check(sum(ragged_counts(ragged_mod).values()) == 0,
          "the training path launched a ragged kernel")
    model_compare_phase(fa)
    lap("6, 7 (training)")
    recipe_launches = recipe_phase(card, fa, phase6_tps)
    for name, n in recipe_launches.items():
        flash_launches[name] += n
    check(sum(ragged_counts(ragged_mod).values()) == 0,
          "the pretraining recipe launched a ragged kernel")
    lap("19 (the pretraining recipe)")
    gc.collect()
    torch.cuda.empty_cache()
    b1, fp16_launches = slice13_phase(card, fa, ragged_mod, reqs, fp_tps)
    launches += b1
    lap("20 (MoE, BERT, sequence parallelism, fp16)")
    gc.collect()
    torch.cuda.empty_cache()
    mesh_flash, phase21 = mesh_train_phase(card, fa)
    for name, n in mesh_flash.items():
        flash_launches[name] += n
    check(sum(ragged_counts(ragged_mod).values()) == 0,
          "the mesh training phase launched a ragged kernel")
    lap("21 (training over a mesh)")
    for name, n in mesh_rest_phase(card, fa, phase21).items():
        flash_launches[name] += n
    del phase21
    check(sum(ragged_counts(ragged_mod).values()) == 0,
          "phase 23 launched a ragged kernel")
    lap("23 (pipelines beside dp and mp, ZeRO-3 a unit at a time, the "
        "meta-optimizers beside mp)")
    gc.collect()
    torch.cuda.empty_cache()
    zero_flash_counts(fa)
    tensor_layer_phase(card)
    check(sum(flash_counts(fa).values()) == 0 and
          sum(ragged_counts(ragged_mod).values()) == 0,
          "phase 24 launched a kernel")
    lap("24 (the Paddle tensor layer)")
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in nn_phase(card, fa).items():
        flash_launches[name] += n
    check(sum(ragged_counts(ragged_mod).values()) == 0,
          "phase 25 launched a ragged kernel")
    lap("25 (the nn layer system)")
    gc.collect()
    torch.cuda.empty_cache()
    zero_flash_counts(fa)
    zero_ragged_counts(ragged_mod)
    hapi_phase(card)
    check(sum(flash_counts(fa).values()) == 0 and
          sum(ragged_counts(ragged_mod).values()) == 0,
          "phase 26 launched a kernel")
    lap("26 (the data pipeline and the high-level API)")

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
    for dtype, tag in (("bfloat16", ""), ("float16", "_fp16")):
        for kernel in FLASH_KERNELS:
            r = fres[kernel, dtype]
            source = {"tensor_core": "flash_attention_sm90.cu",
                      "scalar": "flash_attention.cu"}[
                          fa.entry(kernel, getattr(torch, dtype), 128)[0]]
            kernels.append({
                "name": f"flash_{kernel}{tag}",
                "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{source}",
                "replaces": FLASH_REPLACES[kernel],
                "launches": (flash_launches[kernel] if dtype == "bfloat16"
                             else fp16_launches[kernel]),
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
