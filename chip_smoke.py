#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``paddle_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and
without the last line:

1. Device: a CUDA card must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel under ``paddle_tpu_torch/csrc`` with
   nvcc for sm_90a (one nvcc per source, all at once) and prints
   ptxas's register / shared-memory / spill report.
3. Kernels against their plain versions at gpt2-medium's shapes on the
   serving path (H=16, hd=64, block 16, 8 slots, a 64-lane window, 64
   table entries, 513 pool blocks), with decode lanes, prefill-chunk
   lanes, a parked slot and a horizon at the table's last block: fp32
   at atol 2e-6 / rtol 2e-5 (summation order), bf16 at 2e-2 / 2e-2
   against the plain version in f32 on the same bf16 values (bf16
   rounding of the output); lanes past width exactly 0.  Times the
   kernel, the plain version and ``scaled_dot_product_attention`` (the
   library yardstick, over pre-gathered rows; the port never calls it)
   with CUDA events, and computes the bound.
4. The slice at full width: ``GPTModel.from_config("gpt2-medium")`` in
   fp32 from a seed, ``Engine(num_slots=8, max_seq_len=1024,
   kv_block_size=16, prefill_chunk=64)``, 12 requests (prompts of 17 to
   900 tokens, four sharing a 48-token system prompt, ten greedy and two
   seeded), ``run_until_idle()``.  Checks: every greedy token is the
   argmax of the dense forward over prompt + output (teacher forcing;
   near ties under a 1e-4 margin are counted, not failed), the kernel
   launched exactly 24 times per ragged dispatch, prefix hits > 0, and
   the seeded streams repeat on a second engine.  A third run of the
   same traffic under ``torch.profiler`` prints the device's busy share
   and the kernels that take the most device time.
5. Prints ``{"ok": true, "device": {...}}`` as the last line.

Needs the repository around it: alone in a directory it exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
N_LAYERS = 24                      # gpt2-medium


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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
def kernel_inputs(gen):
    """gpt2-medium serving shapes with mixed per-slot pos / width."""
    import torch
    B, W, H, hd, bs, nb, NB = 8, 64, 16, 64, 16, 64, 513
    # (pos, width): decode lanes at contexts 1, 1000 and 348, prefill
    # chunks of 64, 17 and 40, a parked slot, a chunk whose horizon is
    # the table's last block
    lanes = [(0, 1), (999, 1), (347, 1), (128, 64), (500, 17), (0, 0),
             (1000, 24), (700, 40)]
    pos = torch.tensor([p for p, _ in lanes], dtype=torch.int32)
    width = torch.tensor([w for _, w in lanes], dtype=torch.int32)
    # every slot its own blocks (8 x 64 = the 512 allocatable ones);
    # the parked slot points at the scratch block 0
    perm = torch.randperm(NB - 1,
                          generator=torch.Generator().manual_seed(0)) + 1
    tables = perm.view(B, nb).int()
    for b, (_, w) in enumerate(lanes):
        if not w:
            tables[b] = 0
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
              f"bound_ms {bound:.4f} ({bound_by})", flush=True)
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


def serve(model, reqs, engine_cls):
    import torch
    eng = engine_cls(model, num_slots=8, max_seq_len=1024,
                     kv_block_size=16, prefill_chunk=64)
    handles = [eng.submit(p, max_new_tokens=32, **kw) for p, kw in reqs]
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
    print(f"slice gpt2-medium fp32: ticks {eng.ticks} ragged_dispatches "
          f"{eng.ragged_dispatches} generated_tokens {gen_tokens} "
          f"prefill_tokens {eng.prefill_tokens} prefix_hits "
          f"{eng.prefix_hits} prefix_hit_tokens {eng.prefix_hit_tokens} "
          f"kv_blocks_walked {eng.kv_blocks_walked} "
          f"kernel_launches {launches} wall_s {wall:.3f} tokens_per_s "
          f"{gen_tokens / wall:.2f} greedy_checked {checked} near_ties "
          f"{near} [{card}]", flush=True)
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
    return launches


def profile_phase(model, reqs, engine_cls, card):
    """Where a tick's time goes: the same traffic once more under
    torch.profiler; prints the device's busy share of the wall time and
    the kernels that took the most device time.  Profiler overhead
    stretches this run's wall time; the share is of this run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, _, wall = serve(model, reqs, engine_cls)
    dev = [e for e in prof.key_averages()
           if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    print(f"profile: ticks {eng.ticks} wall_s {wall:.3f} device_busy_s "
          f"{busy_ms / 1e3:.3f} busy_share {busy_ms / 1e3 / wall:.3f} "
          f"[{card}]", flush=True)
    dev.sort(key=lambda e: -e.self_device_time_total)
    for e in dev[:10]:
        print(f"profile kernel: {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d}x {e.key[:90]}", flush=True)


def main():
    import torch
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
    from paddle_tpu_torch.ops import ragged_paged_attn as ragged_mod
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {len(reports)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    kres = kernel_phase(ragged_mod)
    launches = slice_phase(card, ragged_mod)

    f32 = kres["float32"]
    line = {"kernels": [{
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
    }], "card": card}
    print(json.dumps(line), flush=True)
    print(f"{card}", flush=True)
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
