#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; no phase is skipped or
caught):

1. the card: name and power limit (nvidia-smi), TF32 switched off for
   matmuls and convolutions;
2. the kernel build (one nvcc per source, all started together, sm_90a)
   from paddle_tpu_torch/csrc;
3. one phase per paged kernel at the decode slice's shapes (8 slots, 8
   heads, head_dim 64, page_size 16, 128 pages a sequence, a 1025-page
   pool), with float32 and bfloat16 pools: the kernel against its plain
   PyTorch version on the card, plus the kernel's contracts (exact zeros
   for empty slots, non-finite stale tails ignored, and for prefill,
   chunk-split bitwise equal to one call, at chunk starts and lengths on
   and off the kernel's 64-key tiles, C = 1 included, with NaN/Inf
   written past start + C), then the kernel's time, the plain version's,
   the least time the card could take (bound), and one PyTorch library
   call for the same work as a yardstick (prefill at two points: a
   1024-token prompt, and the second 512-token chunk of a prompt);
4. the flash attention kernels (forward B1, fused backward B2: a delta
   pre-pass, the fused kernel and the dq sum) at the training slice's
   shape [64, 8, 256, 64], in float32 and bfloat16, on
   strided q/k/v/do views as the Program feeds them, with mixed kv_lens
   (zeros included): against their plain versions (forward out and lse
   <= 2e-5, backward <= 5e-5 absolute in float32; in bfloat16 <= 1e-2 of
   max(1, |value|), since one bf16 rounding grows with the value) for causal
   and not causal, causal T < S and an uneven tail (T = 200); rows with
   kv_lens 0 give zero out and zero, finite gradients; NaN/Inf written
   past kv_lens leaves every output bitwise unchanged; two backward calls
   give the same bits, and so do two forward calls and a forward over
   one sequence alone (batched == unbatched); then each kernel's time
   beside its plain version's, its bound and a
   scaled_dot_product_attention yardstick (its autograd backward for B2);
5. the two-pass flash backward (B3: a delta pre-pass, the dk/dv kernel
   and the dq kernel) on the same cases, f32 and bf16: against its plain
   version (the tiled two-pass translation) and against B2 on the same
   inputs, and B2 against the same plain version, with the backward
   tolerances above; rows with kv_lens 0 give zero gradients, NaN/Inf
   past kv_lens leaves every output bitwise unchanged, two calls give the
   same bits;
6. the backward engine sweep at bench.py's four Transformer shapes
   ([64, 8, 256, 64], [16, 8, 1024, 64], [8, 8, 2048, 64],
   [4, 8, 4096, 64], the last the long leg's), then B*H across the
   ``auto`` rule's former cut: [16..32, 8, 512, 64], [48, 8, 384, 64],
   [24..32, 4, 512, 128], [64, 4, 256, 128], and past it at
   [128, 8, 256, 64] and [64, 8, 256, 32]; float32, causal and full, the
   training feeds' kv_lens.  At each shape the forward, B2 and B3 are
   held against their plain versions (the tolerances above) and B3
   against B2; then B2's and B3's device times (each engine's three
   kernels from a torch.profiler window, B2's dq sum on its own; the
   faster engine is decided on these) and
   CUDA-event times, SDPA's autograd backward as a yardstick, the plain
   versions' and the bound (10*D operations a visible pair), with the
   engine ``auto`` picks; beside them the forward B1's device time (from
   a profiler window), SDPA's forward, B1's plain version and its bound
   (4*D operations a visible pair);
7. serving: the Transformer LM at the documented decode width
   (vocab 32000, 12 layers, 8 heads, d_model 512, d_inner 2048, random
   weights from a seed) through InferenceEngine.generate: 16 concurrent
   greedy requests, prompts of 32-1500 tokens, 64 new tokens each.  Both
   paged kernels' launch counts must move by layers x steps, and a few
   requests must come out bitwise equal from a max_active=1 engine;
   the LM's logits on the card are held against the plain CPU versions
   on a short input; a short profiled window then splits the device
   time by kernel family and gives the device's idle share;
8. training, card vs CPU: Transformer-base at full width (6+6 layers,
   d_model 512, vocab 30000, dropout 0) from one set of numpy
   parameters: one step's loss (1e-4 relative) and every <param>@GRAD
   (1e-3 of that tensor's max |g|; the few fc units whose ReLU gate opens
   on one side only are found and left out of their own fc's weight and
   bias check, and counted) through Executor.run on the card against the
   port's plain CPU path, twice: batch 2 x 64 with the fused engine (B2
   against the plain backward), then batch 2 x 200 with the pair engine
   on both sides (B3 against its plain version; several tiles and an
   uneven last one); their flash launches are counted apart from the
   main paths' (each step is its engine's main path when ``auto`` runs
   that engine on neither training leg);
9. training: Transformer-base as the JAX package's headline leg
   (bench.py: batch 64 x 256, vocab 30000, dropout 0.1, Adam with noam
   decay, use_flash=True, float32 with TF32 off) through
   Executor.run(startup) and 10 Executor.run(main) steps on seeded token
   feeds whose rows have their own lengths (64-256, pad tails), the
   backward engine left to ``auto``: every loss finite, every parameter
   finite and moved, the forward and the picked backward launched 18
   times a step; step time, target tokens/s, peak memory, the loss
   trajectory, and a profiled step split by kernel family with the
   device's idle share;
10. the long-context leg: the same model at bench.py's longest leg
   (batch 4 x 4096, max_length 4096, rows of 64-4096 tokens), 5 steps
   under ``auto``: the same checks, with B1 and the backward ``auto``
   picks launched 18 times a step and the other engine not at all;
11. a ``kernels`` JSON line (all six kernels: times at the shape of
   their main path, launches from it; B3's two kernels have no library
   call of their own, so their entries also carry the pair's time beside
   SDPA's whole backward; B1's and B2's also carry their figures at the
   long leg's shape (B2's dq sum apart) and their launches there), the
   card line, and the final
   ``{"ok": true, "device": {...}}`` line.

It needs the repository beside it and a CUDA device; without either it
exits non-zero before printing any result.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
# the decode slice's shapes (docs/serving.md, "Autoregressive decode")
S, H, DH, PS, MP = 8, 8, 64, 16, 128
NUM_PAGES = S * MP + 1
LM_WIDTH = dict(vocab_size=32000, n_layer=12, n_head=8, d_model=512,
                d_inner=2048, max_length=2048)
DECODE_CONFIG = dict(num_slots=8, page_size=16, max_seq_len=2048,
                     max_new_tokens=256)
N_REQUESTS, NEW_TOKENS = 16, 64
KERNEL_TOL = 2e-5   # kernel vs plain, f32 math on both: summation order only
# paged prefill cases (start, C), each also split in two calls at C // 2:
# the slice's chunk shapes, then starts off the 64-key tiles, a ragged C
# split off a tile boundary and a one-row chunk
PREFILL_CASES = ((0, 16), (0, 512), (256, 256), (1024, 1024), (0, 2048),
                 (16, 48), (1008, 40), (0, 100), (37, 1))
# timed too: a monolithic prefill of 1024 tokens (the kernels line's
# shape), and the second chunk of a chunked prefill
PREFILL_TIMED = ((0, 1024), (1024, 512))
# the training slice's attention shape: [batch, heads, tokens, head_dim]
FB, FH, FT, FD = 64, 8, 256, 64
# kernel vs plain (forward, backward): f32 math on both, so summation order
# only.  bf16 outputs are rounded once from f32, half an ulp or 2**-9 of
# the value, so their error is taken relative to max(1, |value|)
FLASH_TOL = {"float32": (2e-5, 5e-5), "bfloat16": (1e-2, 1e-2)}
TRAIN_CFG = dict(batch_size=64, seq_len=256, src_vocab_size=30000,
                 trg_vocab_size=30000, max_length=256, use_flash=True)
TRAIN_STEPS = 10
CHECK_CFG = dict(TRAIN_CFG, batch_size=2, seq_len=64, dropout=0.0)
# the card-vs-CPU step with the pair engine: several 64-row tiles and an
# uneven last one
PAIR_CHECK_CFG = dict(CHECK_CFG, seq_len=200, max_length=200)
# the long-context leg: bench.py's longest Transformer leg (4 x 4096)
LONG_CFG = dict(TRAIN_CFG, batch_size=4, seq_len=4096, max_length=4096)
LONG_STEPS = 5
# the flash kernel cases: (causal, T, S, NaN/Inf check)
FLASH_CASES = ((False, FT, FT, True), (True, FT, FT, True),
               (True, 128, FT, False), (False, 200, 200, False),
               (True, 200, 200, False))
# the engine sweep's [B, H, T, D]: bench.py's four Transformer legs (tokens
# held at 16,384; the last is the long leg's), then B*H across B2's slots
# at D 64 (264 slots on 132 SMs) and at D 128 (132 slots), and past them
# (fill 3.9 at D 64; D 32, 396 slots)
SWEEP_SHAPES = ((64, 8, 256, 64), (16, 8, 1024, 64), (8, 8, 2048, 64),
                (4, 8, 4096, 64),
                (16, 8, 512, 64), (20, 8, 512, 64), (24, 8, 512, 64),
                (28, 8, 512, 64), (32, 8, 512, 64), (48, 8, 384, 64),
                (24, 4, 512, 128), (28, 4, 512, 128), (32, 4, 512, 128),
                (64, 4, 256, 128), (128, 8, 256, 64), (64, 8, 256, 32))
FLASH_BWD_KERNELS = {"fused": ("flash_attention_bwd",),
                     "pair": ("flash_attention_bwd_dkv",
                              "flash_attention_bwd_dq")}
LOSS_RTOL = 1e-4    # card vs CPU loss: GEMM summation orders differ
GRAD_RTOL = 1e-3    # card vs CPU, of each tensor's max |g|
LOGIT_TOL = 2e-3    # card vs CPU over 12 layers: GEMM summation orders differ
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor) peak
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(*args):
    print(*args, flush=True)


def check(ok, *what):
    """Fail the run (non-zero exit) unless ``ok``."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: %r" % (what,))


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def timed(fn, iters, flush, warmup=2):
    """(mean device time of ``fn`` in ms over ``iters`` launches, its last
    result); each launch is timed alone by CUDA events with the L2 cache
    flushed before it (the main path reaches each layer's pool cold)."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for a, b in zip(starts, ends):
        flush.zero_()
        a.record()
        result = fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / iters, result


def time_ms(fn, iters, flush, warmup=2):
    return timed(fn, iters, flush, warmup)[0]


def kernel_ms(torch, fn, iters, flush, names):
    """Mean device time a launch, in ms, of each kernel whose name holds
    one of ``names``, read from a torch.profiler window over ``iters``
    calls of ``fn`` (the L2 cache flushed before each), and the launches
    of each the profiler recorded: it may drop a few of a window's
    events, so the mean is over those it kept, and each kernel must
    show up at least once."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(names, 0.0)
    count = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in e.name:
                total[n] += e.time_range.elapsed_us()
                count[n] += 1
    check(all(0 < c <= iters for c in count.values()),
          "profiler saw no launch of a kernel", count, iters)
    return {n: total[n] / count[n] / 1e3 for n in names}, count


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNEL_NAMES = ("paged_decode_kernel", "paged_prefill_kernel",
                "flash_fwd_kernel", "flash_bwd_fused_kernel",
                "flash_bwd_dq_sum_kernel", "flash_bwd_delta_kernel",
                "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
# the device kernels of each backward engine (names as the profiler shows
# them; no name holds another): B2's three launches and B3's three
B2_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_fused_kernel",
              "flash_bwd_dq_sum_kernel")
B3_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkv_kernel",
              "flash_bwd_dq_kernel")


def ptxas_report(build_log):
    """(kernel<template arguments>, registers, spill-store bytes) of each
    kernel entry in nvcc's -Xptxas -v log."""
    rows, name, spill = [], None, 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((n for n in KERNEL_NAMES if n + "I" in line), None)
            if kernel:
                args = line.split(kernel + "I", 1)[1].split("EEv", 1)[0]
                args = re.sub(r"Li(\d+)E", r"\1 ", args).replace(
                    "13__nv_bfloat16", "bf16")
                args = re.sub(r" f$", " f32", args)
                name = "%s<%s>" % (kernel, args)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def make_pools(torch, dev, gen):
    """One layer's k/v pools ([P, ps, H, Dh], random), f32 and bf16."""
    k = torch.randn((NUM_PAGES, PS, H, DH), generator=gen, device=dev)
    v = torch.randn((NUM_PAGES, PS, H, DH), generator=gen, device=dev)
    return {"float32": (k, v),
            "bfloat16": (k.to(torch.bfloat16), v.to(torch.bfloat16))}


def decode_phase(torch, fa, dev, flush):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    lens_np = np.array([0, 1, 16, 17, 300, 1024, 2047, 0], np.int32)
    # every slot its own pages (S * MP = NUM_PAGES - 1), in random order
    tables_np = rng.permutation(np.arange(1, NUM_PAGES)).reshape(S, MP)
    tables = torch.as_tensor(tables_np.astype(np.int32), device=dev)
    kv_lens = torch.as_tensor(lens_np, device=dev)
    q = torch.randn((S, H, DH), generator=gen, device=dev)
    scale = 1.0 / DH ** 0.5
    rows = []
    for dtype, (k, v) in make_pools(torch, dev, gen).items():
        out = fa.paged_decode_attention(q, k, v, tables, kv_lens)
        ref = fa._paged_reference(q, k, v, tables, kv_lens, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(err <= KERNEL_TOL, "decode", dtype, err)
        check(bool((out[kv_lens == 0] == 0).all()), "kv_lens == 0 not zero")
        # non-finite garbage past each slot's length must not reach the sum
        kn, vn = k.clone(), v.clone()
        for s, n in enumerate(lens_np):
            if n and n % PS:
                last = tables_np[s, (n - 1) // PS]
                kn[last, n % PS:] = float("nan")
                vn[last, n % PS:] = float("inf")
        out_nan = fa.paged_decode_attention(q, kn, vn, tables, kv_lens)
        check(torch.equal(out_nan, out), "stale non-finite tail leaked")
        del kn, vn
        itemsize = k.element_size()
        nbytes = (int(lens_np.sum()) * H * DH * 2 * itemsize
                  + 2 * q.numel() * 4 + tables.numel() * 4 + S * 4)
        flops = int(lens_np.sum()) * H * DH * 4
        # yardstick: one SDPA call over K/V gathered beforehand
        kg = k[tables.long()].reshape(S, MP * PS, H, DH).float()
        vg = v[tables.long()].reshape(S, MP * PS, H, DH).float()
        kg, vg = kg.transpose(1, 2), vg.transpose(1, 2)
        mask = (torch.arange(MP * PS, device=dev)[None, :]
                < kv_lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        rows.append({
            "dtype": dtype, "max_abs_err": err,
            "ms": time_ms(lambda: fa.paged_decode_attention(
                q, k, v, tables, kv_lens), 50, flush),
            "plain_ms": time_ms(lambda: fa._paged_reference(
                q, k, v, tables, kv_lens, scale), 10, flush),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask), 20, flush),
            "bound": bound_ms(nbytes, flops), "bytes": nbytes,
            "flops": flops})
        del kg, vg
    for r in rows:
        log("decode %-8s S=%d kv_lens=%s err=%.3g (tol %g) kernel %.4f ms "
            "plain %.4f ms sdpa %.4f ms bound %.4f ms (%s)"
            % (r["dtype"], S, lens_np.tolist(), r["max_abs_err"], KERNEL_TOL,
               r["ms"], r["plain_ms"], r["library_ms"], r["bound"][0],
               r["bound"][1]))
    return rows


def prefill_phase(torch, fa, dev, flush):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    pages = torch.as_tensor(rng.choice(np.arange(1, NUM_PAGES), MP,
                                       replace=False).astype(np.int32),
                            device=dev)
    scale = 1.0 / DH ** 0.5
    pages_np = pages.cpu().numpy()
    span = MP * PS
    rows = []
    for dtype, (k, v) in make_pools(torch, dev, gen).items():
        for start, C in PREFILL_CASES + PREFILL_TIMED:
            q = torch.randn((C, H, DH), generator=gen, device=dev)
            out = fa.paged_prefill_attention(q, k, v, pages, start)
            ref = fa._paged_prefill_reference(q, k, v, pages, start, scale)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err <= KERNEL_TOL, "prefill", dtype, start, C, err)
            half = C // 2
            split = torch.cat([
                fa.paged_prefill_attention(q[:half], k, v, pages, start),
                fa.paged_prefill_attention(q[half:], k, v, pages,
                                           start + half)])
            check(torch.equal(split, out), "chunk split", start, C)
            # NaN/Inf in the stale keys past the chunk, up to the end of the
            # 64-key tile that holds its last key (rest of its last page
            # included): every output bit unchanged
            stale = np.arange(start + C, min(span, (start + C) // 64 * 64 + 64))
            nan_checked = len(stale) > 0
            if nan_checked:
                kn, vn = k.clone(), v.clone()
                where = (torch.as_tensor(pages_np[stale // PS], device=dev).long(),
                         torch.as_tensor(stale % PS, device=dev))
                kn[where] = float("nan")
                vn[where] = float("inf")
                out_nan = fa.paged_prefill_attention(q, kn, vn, pages, start)
                check(torch.equal(out_nan, out), "prefill: stale NaN/Inf "
                      "past start + C changed an output", dtype, start, C)
                del kn, vn
            row = {"dtype": dtype, "start": start, "C": C,
                   "max_abs_err": err, "split_bitwise": True,
                   "stale_nan_inert": nan_checked}
            if (start, C) in PREFILL_TIMED:
                itemsize = k.element_size()
                nbytes = ((start + C) * H * DH * 2 * itemsize
                          + 2 * q.numel() * 4 + MP * 4)
                flops = 4 * H * DH * (C * start + C * (C + 1) // 2)
                span = MP * PS
                kg = k[pages.long()].reshape(1, span, H, DH).float()
                vg = v[pages.long()].reshape(1, span, H, DH).float()
                kg, vg = kg.transpose(1, 2), vg.transpose(1, 2)
                mask = (torch.arange(span, device=dev)[None, :]
                        <= start + torch.arange(C, device=dev)[:, None])
                q4 = q.transpose(0, 1)[None]
                row.update({
                    "ms": time_ms(lambda: fa.paged_prefill_attention(
                        q, k, v, pages, start), 20, flush),
                    "plain_ms": time_ms(lambda: fa._paged_prefill_reference(
                        q, k, v, pages, start, scale), 5, flush),
                    "library_ms": time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, kg, vg, attn_mask=mask), 10, flush),
                    "bound": bound_ms(nbytes, flops), "bytes": nbytes,
                    "flops": flops})
                del kg, vg
            rows.append(row)
    for r in rows:
        extra = ""
        if "ms" in r:
            extra = (" kernel %.4f ms plain %.4f ms sdpa %.4f ms bound "
                     "%.4f ms (%s)" % (r["ms"], r["plain_ms"],
                                       r["library_ms"], r["bound"][0],
                                       r["bound"][1]))
        log("prefill %-8s start=%d C=%d err=%.3g (tol %g) split bitwise%s%s"
            % (r["dtype"], r["start"], r["C"], r["max_abs_err"], KERNEL_TOL,
               ", stale NaN/Inf inert" if r["stale_nan_inert"] else "",
               extra))
    return rows


def logits_check(torch, T, params, meta, dev):
    """The LM on the card (kernels) against the plain versions on the
    CPU: one 40-token prompt prefilled in a 48-wide chunk, then 4 decode
    steps; max |logit difference| must stay under LOGIT_TOL."""
    rng = np.random.RandomState(SEED + 2)
    prompt = rng.randint(0, meta["vocab_size"], size=40).astype(np.int32)
    L, nh, hd = meta["n_layer"], meta["n_head"], meta["head_dim"]
    worst = 0.0
    results = {}
    for where in (dev, torch.device("cpu")):
        lm = T.params_from_numpy(params, where, meta=meta)
        pool = lambda: torch.zeros((L, 8, PS, nh, hd), device=where)
        kp, vp = pool(), pool()
        table = torch.tensor([1, 2, 3, 4, 0, 0, 0, 0], dtype=torch.int32,
                             device=where)
        toks = np.zeros(48, np.int32)
        toks[:40] = prompt
        with torch.no_grad():
            out = [T.lm_prefill_chunk(
                lm, torch.as_tensor(toks, device=where), 0, 40, kp, vp,
                table[:3].clone(), table)]
            tok = int(torch.argmax(out[0]))
            for step in range(4):
                pos = 40 + step
                logits = T.lm_decode_step(
                    lm, torch.tensor([tok], dtype=torch.int32, device=where),
                    torch.tensor([pos], dtype=torch.int32, device=where),
                    kp, vp, table[None].clone(),
                    torch.tensor([pos + 1], dtype=torch.int32, device=where))
                out.append(logits[0])
                tok = int(torch.argmax(logits[0]))
        results[where.type] = [o.float().cpu() for o in out]
    for a, b in zip(results["cuda"], results["cpu"]):
        check(bool(torch.isfinite(a).all()), "non-finite logits on the card")
        worst = max(worst, (a - b).abs().max().item())
    check(worst <= LOGIT_TOL, "card vs cpu logits", worst)
    return worst


def profile_window(torch, engine, meta):
    """Where a decode-serving window's device time goes: 8 concurrent
    256-token prompts, 32 new tokens each, under torch.profiler.  Returns
    device time by kernel family and the device's idle share of the
    window's wall time, or "not measured" when the profiler records no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(SEED + 4)
    prompts = [rng.randint(0, meta["vocab_size"], size=256).astype(np.int32)
               for _ in range(8)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [engine.generate_async(p, max_new_tokens=32) for p in prompts]
        for f in futs:
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return "not measured (the profiler recorded no device activity)"
    families = {"paged_decode_kernel": 0.0, "paged_prefill_kernel": 0.0,
                "gemm": 0.0, "memcpy": 0.0, "other": 0.0}
    for e in kernels:
        name = e.name.lower()
        fam = next((f for f in ("paged_decode_kernel", "paged_prefill_kernel")
                    if f in name), None)
        if fam is None:
            fam = ("gemm" if any(k in name for k in ("gemm", "xmma",
                                                       "cutlass", "gemv"))
                   else "memcpy" if "memcpy" in name else "other")
        families[fam] += e.time_range.elapsed_us()
    busy = sum(families.values())
    return {"window_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_family": {k: v / 1e3 for k, v in families.items()},
            "device_events": len(kernels)}


def serving_phase(torch, T, serving, fa, obs, dev):
    params, meta = T.lm_params(seed=SEED, **LM_WIDTH)
    logit_err = logits_check(torch, T, params, meta, dev)
    log("logits card vs cpu (prefill + 4 decode steps): max abs diff %.3g "
        "(tol %g)" % (logit_err, LOGIT_TOL))
    model = T.build_decode_model(params, meta, device=dev)
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, meta["vocab_size"],
                           size=int(n)).astype(np.int32)
               for n in rng.randint(32, 1501, size=N_REQUESTS)]
    t0 = time.perf_counter()
    engine = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            **DECODE_CONFIG), device=dev)
    setup_s = time.perf_counter() - t0
    steps = obs.counter("serving.decode.steps")
    prefills = obs.counter("serving.decode.prefills")
    step_timer = obs.timer("serving.decode.decode_step")
    steps0, prefills0 = steps.value, prefills.value
    timer0 = (step_timer.count, step_timer.total)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [engine.generate_async(p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    launches = dict(fa.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    n_steps = steps.value - steps0
    n_prefills = prefills.value - prefills0
    profile = profile_window(torch, engine, meta)
    engine.stop()
    L = meta["n_layer"]
    check(launches["paged_decode_attention"] == L * n_steps > 0,
          launches, n_steps)
    check(launches["paged_prefill_attention"] == L * n_prefills > 0,
          launches, n_prefills)
    for o in outs:
        check(o.shape == (NEW_TOKENS,) and o.dtype == np.int32, o.shape)
        check(((0 <= o) & (o < meta["vocab_size"])).all(), "token range")
    ttft = np.array([f.token_times[0] - f.enqueue_ts for f in futs])
    step_ms = ((step_timer.total - timer0[1])
               / max(1, step_timer.count - timer0[0]) * 1e3)
    tokens = sum(len(o) for o in outs)
    stats = {"requests": N_REQUESTS, "succeeded": len(outs),
             "prompt_tokens": int(sum(len(p) for p in prompts)),
             "generated_tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall,
             "ttft_p50_ms": float(np.percentile(ttft, 50) * 1e3),
             "ttft_p95_ms": float(np.percentile(ttft, 95) * 1e3),
             "decode_step_ms": step_ms, "decode_steps": n_steps,
             "prefill_chunks": n_prefills,
             "peak_memory_gib": peak / 2 ** 30, "engine_setup_s": setup_s,
             "launches": launches, "profile": profile}
    log("serving: " + json.dumps(stats))
    # continuous batching == serving alone, bitwise
    solo = serving.InferenceEngine(
        decode_model=model, decode_config=serving.DecodeConfig(
            max_active=1, **DECODE_CONFIG), device=dev)
    for i in (0, 7, 15):
        alone = solo.generate(prompts[i], max_new_tokens=NEW_TOKENS,
                              timeout=600)
        check(alone.tobytes() == outs[i].tobytes(),
              "request %d differs batched vs max_active=1" % i)
    solo.stop()
    log("serving: requests 0, 7, 15 bitwise equal to a max_active=1 engine")
    return stats


def flash_inputs(torch, dev, gen, dtype, T, S, B=FB, H=FH, D=FD):
    """q, k, v, do as the Program feeds them: [B, H, T, D] views of
    [B, T, H, D] tensors (strided, last dimension contiguous)."""
    def view(n, scale=1.0):
        x = torch.randn((B, n, H, D), generator=gen, device=dev) * scale
        return x.to(dtype).transpose(1, 2)
    return view(T), view(S), view(S), view(T, 0.1)


def flash_lens(rng, S, with_zeros, B=FB):
    """kv_lens [B]: the training feeds' lengths (64..S), or mixed lengths
    with empty, single-key and full rows."""
    if not with_zeros:
        return rng.randint(min(64, S), S + 1, size=B).astype(np.int32)
    lens = rng.randint(1, S + 1, size=B).astype(np.int32)
    lens[[0, 5, 9]] = 0
    lens[1], lens[2], lens[3] = 1, S, 17
    return lens


def visible_pairs(lens, T, S, causal, H=FH):
    """(query, key) pairs the mask leaves visible, summed over the batch
    and heads (what the kernels compute for these kv_lens)."""
    total = 0
    for n in lens:
        if causal:
            rows = np.arange(T) + (S - T) + 1   # keys each row may see
            total += int(np.minimum(rows, n).clip(0).sum())
        else:
            total += T * int(n)
    return total * H


def flash_bounds(lens, T, S, causal, itemsize, H=FH, D=FD):
    """(forward, backward) bounds: the function's bytes moved once and
    4*D (forward) or 10*D (backward) operations a visible pair."""
    B = len(lens)
    pairs = visible_pairs(lens, T, S, causal, H)
    q_el, kv_el = B * H * T * D, B * H * S * D
    fwd_bytes = (q_el + 2 * kv_el) * itemsize + B * 4 \
        + q_el * itemsize + B * H * T * 4
    bwd_bytes = (3 * q_el + 2 * kv_el) * itemsize + B * H * T * 4 + B * 4 \
        + (q_el + 2 * kv_el) * itemsize
    return (bound_ms(fwd_bytes, 4 * D * pairs),
            bound_ms(bwd_bytes, 10 * D * pairs))


def pair_bounds(lens, T, S, causal, itemsize, H=FH, D=FD):
    """Bounds of B3's two kernels apart: each reads q, k, v, out, do, lse
    and kv_lens once; the dk/dv kernel writes dk and dv and does 8*D
    operations a visible pair (s, dp, dv, dk), the dq kernel writes dq and
    does 6*D (s, dp, dq)."""
    B = len(lens)
    pairs = visible_pairs(lens, T, S, causal, H)
    q_el, kv_el = B * H * T * D, B * H * S * D
    reads = (3 * q_el + 2 * kv_el) * itemsize + B * H * T * 4 + B * 4
    return (bound_ms(reads + 2 * kv_el * itemsize, 8 * D * pairs),
            bound_ms(reads + q_el * itemsize, 6 * D * pairs))


def flash_err(a, r, dtype):
    """float32: absolute.  bfloat16: absolute up to |value| 1, relative
    above it — one rounding to bf16 costs up to 2**-9 of the value."""
    d = (a.float() - r.float()).abs()
    if dtype == "bfloat16":
        d = d / r.float().abs().clamp_min(1.0)
    return d.max().item()


def flash_case(torch, fa, dev, gen, rng, dtype, causal, T, S, nan_check):
    """One kernel-vs-plain case of both flash kernels; returns errors."""
    q, k, v, do = flash_inputs(torch, dev, gen, dtype, T, S)
    lens_np = flash_lens(rng, S, with_zeros=True)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / FD ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    grads = fa._flash_bwd_cuda(q, k, v, lens, out, lse, do, causal, scale)
    # the plain versions on the same values widened to float32 (exactly):
    # f32 math as in the kernels, results not rounded back to bf16
    f32 = [x.float() for x in (q, k, v, out, do)]
    r_out, r_lse = fa._flash_fwd_reference(*f32[:3], lens, causal, scale)
    r_grads = fa._flash_bwd_reference(*f32[:3], lens, f32[3], lse, f32[4],
                                      causal, scale)
    torch.cuda.synchronize()
    dtype = str(dtype).replace("torch.", "")
    err = lambda a, r: flash_err(a, r, dtype)  # noqa: E731

    fwd_err = max(err(out, r_out), err(lse, r_lse))
    bwd_err = max(err(g, r) for g, r in zip(grads, r_grads))
    tol_f, tol_b = FLASH_TOL[dtype]
    what = (dtype, "causal" if causal else "full", T, S)
    check(fwd_err <= tol_f, "flash fwd vs plain", what, fwd_err)
    check(bwd_err <= tol_b, "flash bwd vs plain", what, bwd_err)
    dead = torch.as_tensor(lens_np == 0, device=dev)
    check(bool((out[dead] == 0).all()), "kv_lens 0: out not zero", what)
    for g in grads:
        check(bool(torch.isfinite(g).all()), "non-finite gradient", what)
    check(bool((grads[0][dead] == 0).all()), "kv_lens 0: dq not zero", what)
    for b, n in enumerate(lens_np):
        check(bool((grads[1][b, :, n:] == 0).all()
                   and (grads[2][b, :, n:] == 0).all()),
              "dk/dv past kv_lens not zero", what, b)
    again = fa._flash_bwd_cuda(q, k, v, lens, out, lse, do, causal, scale)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "flash backward not bitwise repeatable", what)
    # the forward: two calls, and one sequence alone, give the same bits
    out2, lse2 = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    one = slice(3, 4)  # kv_lens 17: a partial first key tile
    out1, lse1 = fa._flash_fwd_cuda(q[one], k[one], v[one], lens[one],
                                    causal, scale)
    check(torch.equal(out2, out) and torch.equal(lse2, lse)
          and torch.equal(out1, out[one]) and torch.equal(lse1, lse[one]),
          "flash forward not bitwise repeatable or batched != unbatched",
          what)
    if nan_check:
        kn, vn = k.clone(), v.clone()
        for b, n in enumerate(lens_np):
            kn[b, :, n:] = float("nan")
            vn[b, :, n:] = float("inf")
        out_n, lse_n = fa._flash_fwd_cuda(q, kn, vn, lens, causal, scale)
        grads_n = fa._flash_bwd_cuda(q, kn, vn, lens, out_n, lse_n, do,
                                     causal, scale)
        check(torch.equal(out_n, out) and torch.equal(lse_n, lse)
              and all(torch.equal(a, b) for a, b in zip(grads_n, grads)),
              "NaN/Inf past kv_lens changed an output", what)
    return {"dtype": dtype, "causal": causal, "T": T, "S": S,
            "fwd_err": fwd_err, "bwd_err": bwd_err, "nan_checked": nan_check,
            "zero_rows": int((lens_np == 0).sum())}


def flash_timing(torch, fa, dev, gen, rng, causal, flush):
    """Both kernels' times at the slice's shape (float32, the training
    feeds' lengths), beside the plain versions, the bound and SDPA."""
    import torch.nn.functional as F

    q, k, v, do = flash_inputs(torch, dev, gen, torch.float32, FT, FT)
    lens_np = flash_lens(rng, FT, with_zeros=False)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / FD ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    mask = (torch.arange(FT, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        mask = mask & torch.ones((FT, FT), dtype=torch.bool, device=dev).tril()
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        s_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    fwd_b, bwd_b = flash_bounds(lens_np, FT, FT, causal, 4)
    row = {
        "causal": causal, "kv_lens_mean": float(lens_np.mean()),
        "fwd": {"ms": time_ms(lambda: fa._flash_fwd_cuda(
                    q, k, v, lens, causal, scale), 20, flush),
                "plain_ms": time_ms(lambda: fa._flash_fwd_reference(
                    q, k, v, lens, causal, scale), 5, flush),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask), 20, flush),
                "bound": fwd_b},
        "bwd": {"ms": time_ms(lambda: fa._flash_bwd_cuda(
                    q, k, v, lens, out, lse, do, causal, scale), 20, flush),
                "plain_ms": time_ms(lambda: fa._flash_bwd_reference(
                    q, k, v, lens, out, lse, do, causal, scale), 5, flush),
                "library_ms": time_ms(lambda: torch.autograd.grad(
                    s_out, (qg, kg, vg), do, retain_graph=True), 20, flush),
                "bound": bwd_b}}
    return row


def flash_phase(torch, fa, dev, flush):
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    rng = np.random.RandomState(SEED + 10)
    cases = []
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for causal, T, S, nan_check in FLASH_CASES:
            cases.append(flash_case(torch, fa, dev, gen, rng, td, causal,
                                    T, S, nan_check))
    for c in cases:
        log("flash %-8s %-6s T=%d S=%d fwd err %.3g bwd err %.3g (tol %g/%g) "
            "kv_lens==0 rows %d zero%s, bwd bitwise repeatable"
            % (c["dtype"], "causal" if c["causal"] else "full", c["T"],
               c["S"], c["fwd_err"], c["bwd_err"], *FLASH_TOL[c["dtype"]],
               c["zero_rows"], ", NaN/Inf past kv_lens inert"
               if c["nan_checked"] else ""))
    timing = [flash_timing(torch, fa, dev, gen, rng, causal, flush)
              for causal in (False, True)]
    for t in timing:
        for kind in ("fwd", "bwd"):
            r = t[kind]
            log("flash %s %-6s [%d,%d,%d,%d] f32 kv_lens mean %.1f: kernel "
                "%.4f ms plain %.4f ms sdpa %.4f ms bound %.4f ms (%s)"
                % (kind, "causal" if t["causal"] else "full", FB, FH, FT, FD,
                   t["kv_lens_mean"], r["ms"], r["plain_ms"],
                   r["library_ms"], r["bound"][0], r["bound"][1]))
    return cases, timing


def pair_case(torch, fa, dev, gen, rng, dtype, causal, T, S, nan_check):
    """One case of B3 (both kernels) against its plain version and against
    B2 on the same inputs, and B2 against the same plain version; returns
    errors."""
    q, k, v, do = flash_inputs(torch, dev, gen, dtype, T, S)
    lens_np = flash_lens(rng, S, with_zeros=True)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / FD ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    grads = fa._flash_bwd_pair_cuda(q, k, v, lens, out, lse, do, causal,
                                    scale)
    fused = fa._flash_bwd_cuda(q, k, v, lens, out, lse, do, causal, scale)
    f32 = [x.float() for x in (q, k, v, out, do)]
    r_grads = fa._flash_bwd_pair_reference(*f32[:3], lens, f32[3], lse,
                                           f32[4], causal, scale)
    torch.cuda.synchronize()
    dtype = str(dtype).replace("torch.", "")
    errs = [flash_err(g, r, dtype) for g, r in zip(grads, r_grads)]
    b2_err = max(flash_err(g, f, dtype) for g, f in zip(grads, fused))
    b2_plain_err = max(flash_err(f, r, dtype) for f, r in zip(fused, r_grads))
    tol = FLASH_TOL[dtype][1]
    what = (dtype, "causal" if causal else "full", T, S)
    check(max(errs) <= tol, "pair bwd vs plain", what, errs)
    check(b2_err <= tol, "pair bwd vs B2", what, b2_err)
    check(b2_plain_err <= tol, "B2 vs plain", what, b2_plain_err)
    dead = torch.as_tensor(lens_np == 0, device=dev)
    for g in grads:
        check(bool(torch.isfinite(g).all()), "pair: non-finite gradient",
              what)
        check(bool((g[dead] == 0).all()), "pair: kv_lens 0 not zero", what)
    for b, n in enumerate(lens_np):
        check(bool((grads[1][b, :, n:] == 0).all()
                   and (grads[2][b, :, n:] == 0).all()),
              "pair: dk/dv past kv_lens not zero", what, b)
    again = fa._flash_bwd_pair_cuda(q, k, v, lens, out, lse, do, causal,
                                    scale)
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          "pair backward not bitwise repeatable", what)
    if nan_check:
        kn, vn = k.clone(), v.clone()
        for b, n in enumerate(lens_np):
            kn[b, :, n:] = float("nan")
            vn[b, :, n:] = float("inf")
        grads_n = fa._flash_bwd_pair_cuda(q, kn, vn, lens, out, lse, do,
                                          causal, scale)
        check(all(torch.equal(a, b) for a, b in zip(grads_n, grads)),
              "pair: NaN/Inf past kv_lens changed an output", what)
    return {"dtype": dtype, "causal": causal, "T": T, "S": S,
            "dq_err": errs[0], "dkv_err": max(errs[1:]), "b2_err": b2_err,
            "b2_plain_err": b2_plain_err, "nan_checked": nan_check,
            "zero_rows": int((lens_np == 0).sum())}


def pair_phase(torch, fa, dev):
    """B3 on the flash cases, f32 and bf16."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rng = np.random.RandomState(SEED + 11)
    cases = [pair_case(torch, fa, dev, gen, rng, getattr(torch, dtype),
                       causal, T, S, nan_check)
             for dtype in ("float32", "bfloat16")
             for causal, T, S, nan_check in FLASH_CASES]
    for c in cases:
        log("pair %-8s %-6s T=%d S=%d dq err %.3g dk/dv err %.3g vs B2 %.3g "
            "(B2 vs plain %.3g; tol %g) kv_lens==0 rows %d zero, bitwise "
            "repeatable%s"
            % (c["dtype"], "causal" if c["causal"] else "full", c["T"],
               c["S"], c["dq_err"], c["dkv_err"], c["b2_err"],
               c["b2_plain_err"],
               FLASH_TOL[c["dtype"]][1], c["zero_rows"],
               ", NaN/Inf past kv_lens inert" if c["nan_checked"] else ""))
    return cases


def sweep_row(torch, fa, dev, flush, shape, causal, gen, rng):
    """B2 against B3 (each engine's three kernels from a profiler window:
    B2's delta pre-pass, fused kernel and dq sum, B3's delta pre-pass,
    dk/dv and dq kernels), the plain versions, the bound and SDPA's
    backward at one sweep shape [B, H, T, D], float32, with the training
    feeds' kv_lens;
    beside them the forward (B1: its device time from a profiler window,
    its plain version's, SDPA's forward and the 4*D bound).  The forward,
    B2 and B3 are held against their plain versions on these inputs."""
    import torch.nn.functional as F

    B, H, T, D = shape
    q, k, v, do = flash_inputs(torch, dev, gen, torch.float32, T, T, B, H, D)
    lens_np = flash_lens(rng, T, with_zeros=False, B=B)
    lens = torch.as_tensor(lens_np, device=dev)
    scale = 1.0 / D ** 0.5
    out, lse = fa._flash_fwd_cuda(q, k, v, lens, causal, scale)
    args = (q, k, v, lens, out, lse, do, causal, scale)
    iters = {256: 20, 384: 20, 512: 20, 1024: 10, 2048: 5}.get(T, 3)
    plain_iters = 3 if T <= 512 else 1
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        mask = mask & torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        s_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
    fwd_b, bwd_b = flash_bounds(lens_np, T, T, causal, 4, H, D)
    dkv_b, dq_b = pair_bounds(lens_np, T, T, causal, 4, H, D)
    fwd_dev, _ = kernel_ms(torch, lambda: fa._flash_fwd_cuda(
        q, k, v, lens, causal, scale), iters, flush, ("flash_fwd_kernel",))
    b2_ms, b2 = timed(lambda: fa._flash_bwd_cuda(*args), iters, flush)
    b2_apart, b2_seen = kernel_ms(torch, lambda: fa._flash_bwd_cuda(*args),
                                  iters, flush, B2_KERNELS)
    pair_ms, pair = timed(lambda: fa._flash_bwd_pair_cuda(*args), iters,
                          flush)
    apart, seen = kernel_ms(torch, lambda: fa._flash_bwd_pair_cuda(*args),
                            iters, flush, B3_KERNELS)
    b2_plain_ms, b2_plain = timed(lambda: fa._flash_bwd_reference(*args),
                                  plain_iters, flush, 1)
    dkv_plain_ms, dkv_plain = timed(lambda: fa._pair_dkv_reference(*args),
                                    plain_iters, flush, 1)
    dq_plain_ms, dq_plain = timed(lambda: fa._pair_dq_reference(*args),
                                  plain_iters, flush, 1)
    fwd_plain_ms, (r_out, r_lse) = timed(
        lambda: fa._flash_fwd_reference(q, k, v, lens, causal, scale),
        plain_iters, flush, 1)
    torch.cuda.synchronize()
    err = lambda a, r: flash_err(a, r, "float32")  # noqa: E731
    errs = {"fwd": max(err(out, r_out), err(lse, r_lse)),
            "b2": max(err(g, r) for g, r in zip(b2, b2_plain)),
            "dkv": max(err(g, r) for g, r in zip(pair[1:], dkv_plain)),
            "dq": err(pair[0], dq_plain),
            "pair_vs_b2": max(err(g, r) for g, r in zip(pair, b2))}
    tol_f, tol_b = FLASH_TOL["float32"]
    what = (shape, "causal" if causal else "full")
    check(errs["fwd"] <= tol_f, "sweep: flash fwd vs plain", what, errs)
    check(max(errs["b2"], errs["dkv"], errs["dq"], errs["pair_vs_b2"])
          <= tol_b, "sweep: flash bwd vs plain", what, errs)
    row = {
        "shape": list(shape), "causal": causal,
        "kv_lens_mean": float(lens_np.mean()), "errs": errs,
        "b2_ms": b2_ms, "pair_ms": pair_ms,
        "b2_dev_ms": sum(b2_apart.values()),
        "b2_fused_ms": b2_apart["flash_bwd_fused_kernel"],
        "b2_dq_sum_ms": b2_apart["flash_bwd_dq_sum_kernel"],
        "b2_delta_ms": b2_apart["flash_bwd_delta_kernel"],
        "b2_profiled_launches": b2_seen,
        "pair_dev_ms": sum(apart.values()),
        "dkv_ms": apart["flash_bwd_dkv_kernel"],
        "dq_ms": apart["flash_bwd_dq_kernel"],
        "delta_ms": apart["flash_bwd_delta_kernel"], "profiled_launches": seen,
        "iters": iters,
        "fwd_dev_ms": fwd_dev["flash_fwd_kernel"],
        "fwd_plain_ms": fwd_plain_ms, "fwd_bound": fwd_b,
        "sdpa_fwd_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters, flush),
        "sdpa_bwd_ms": time_ms(lambda: torch.autograd.grad(
            s_out, (qg, kg, vg), do, retain_graph=True), iters, flush),
        "b2_plain_ms": b2_plain_ms, "dkv_plain_ms": dkv_plain_ms,
        "dq_plain_ms": dq_plain_ms,
        "bound": bwd_b, "dkv_bound": dkv_b, "dq_bound": dq_b,
        "auto": fa._pick_bwd_engine(B, H, D, fa._sm_count(0))}
    row["pair_plain_ms"] = row["dkv_plain_ms"] + row["dq_plain_ms"]
    # which engine is faster on the device: the kernels' own times from the
    # profiler (a CUDA-event time of an engine's three launches also takes
    # in the host's gaps between them)
    row["faster"] = ("fused" if row["b2_dev_ms"] <= row["pair_dev_ms"]
                     else "pair")
    # B2's grid, B*H*ceil(T/64) blocks, as a share of the blocks the card
    # holds at once
    row["b2_fill"] = (B * H * -(-T // 64)
                      / (fa._b2_blocks_per_sm(D) * fa._sm_count(0)))
    return row


def engine_sweep(torch, fa, dev, flush):
    """The backward engines at the sweep's shapes, causal and full: the
    measurements the ``auto`` rule is set from."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    rng = np.random.RandomState(SEED + 12)
    rows = []
    for shape in SWEEP_SHAPES:
        for causal in (False, True):
            rows.append(sweep_row(torch, fa, dev, flush, shape, causal, gen,
                                  rng))
            torch.cuda.empty_cache()
    for r in rows:
        log("sweep %s %-6s f32 kv_lens mean %.1f, B2's grid %.2f of its "
            "slots: device B2 %.4f ms (delta %.4f + fused %.4f + dq sum "
            "%.4f, %d + %d of %d profiled), B3 %.4f ms (delta %.4f + dkv "
            "%.4f + dq %.4f, %d + %d of %d profiled) | CUDA events B2 %.4f "
            "ms, B3 %.4f ms | "
            "sdpa bwd %.4f ms | plain B2 %.4f ms, B3 %.4f ms (dkv %.4f + dq "
            "%.4f) | bound %.4f ms (%s) "
            "| faster %s, auto picks %s | B1 fwd device %.4f ms, sdpa fwd "
            "%.4f ms, plain %.4f ms, bound %.4f ms (%s) | err vs plain: fwd "
            "%.3g B2 %.3g dkv %.3g dq %.3g, B3 vs B2 %.3g (tol %g/%g)"
            % (r["shape"], "causal" if r["causal"] else "full",
               r["kv_lens_mean"], r["b2_fill"], r["b2_dev_ms"],
               r["b2_delta_ms"], r["b2_fused_ms"], r["b2_dq_sum_ms"],
               r["b2_profiled_launches"]["flash_bwd_fused_kernel"],
               r["b2_profiled_launches"]["flash_bwd_dq_sum_kernel"],
               r["iters"],
               r["pair_dev_ms"], r["delta_ms"], r["dkv_ms"], r["dq_ms"],
               r["profiled_launches"]["flash_bwd_dkv_kernel"],
               r["profiled_launches"]["flash_bwd_dq_kernel"], r["iters"],
               r["b2_ms"], r["pair_ms"],
               r["sdpa_bwd_ms"], r["b2_plain_ms"],
               r["pair_plain_ms"], r["dkv_plain_ms"], r["dq_plain_ms"],
               r["bound"][0], r["bound"][1], r["faster"], r["auto"],
               r["fwd_dev_ms"], r["sdpa_fwd_ms"], r["fwd_plain_ms"],
               r["fwd_bound"][0], r["fwd_bound"][1], r["errs"]["fwd"],
               r["errs"]["b2"], r["errs"]["dkv"], r["errs"]["dq"],
               r["errs"]["pair_vs_b2"],
               *FLASH_TOL["float32"]))
    return rows


def make_feeds(rng, batch, seq, vocab):
    """Seeded token feeds: every row its own length (64..seq, at most
    seq), with PAD_IDX (0) tails; labels share the target's length."""
    lo = min(64, seq)
    src = rng.randint(3, vocab, size=(batch, seq)).astype(np.int64)
    trg = rng.randint(3, vocab, size=(batch, seq)).astype(np.int64)
    lbl = rng.randint(3, vocab, size=(batch, seq)).astype(np.int64)
    for b in range(batch):
        ls, lt = rng.randint(lo, seq + 1, size=2)
        src[b, ls:] = 0
        trg[b, lt:] = 0
        lbl[b, lt:] = 0
    return {"src_word": src, "trg_word": trg, "lbl_word": lbl}


def relu_gates(program):
    """For each relu of the Program's fc layers: (pre-activation var,
    weight name, bias name), read from the op chain mul -> elementwise_add
    -> relu that layers.fc(act="relu") builds."""
    producer = {n: op for op in program.global_block().ops
                for ns in op.outputs.values() for n in ns}
    out = []
    for op in program.global_block().ops:
        if op.type != "relu":
            continue
        pre = op.inputs["X"][0]
        add = producer[pre]
        mul = producer[add.inputs["X"][0]]
        out.append((pre, mul.inputs["Y"][0], add.inputs["Y"][0]))
    return out


def bwd_engine(fa, engine, cfg):
    """The backward engine the card runs for a training config's
    attention calls (all [batch, FH, seq, FD] against seq keys)."""
    if engine == "auto":
        return fa._pick_bwd_engine(cfg["batch_size"], FH, FD,
                                   fa._sm_count(0))
    return engine


def check_flash_launches(fa, launches, engine, calls, what):
    """The forward and the engine's backward kernels launched ``calls``
    times each; every other flash kernel not at all."""
    want = {n: 0 for sub in FLASH_BWD_KERNELS.values() for n in sub}
    want["flash_attention_fwd"] = calls
    want.update({n: calls for n in FLASH_BWD_KERNELS[engine]})
    check(all(launches[n] == c for n, c in want.items()),
          what + " flash launches", engine, launches)


def train_check_phase(torch, fluid, T, fa, dev, cfg, engine):
    """One training step on the card against the port's plain CPU path,
    from the same numpy parameters, at full width (``cfg``'s batch), with
    the flash backward engine ``engine`` on both sides.

    A ReLU gate whose pre-activation lies within rounding of 0 may open
    on one side and stay shut on the other; that moves its unit's column
    of the fc weight gradient (and bias element) by one token's whole
    contribution, which no summation tolerance covers.  Such units are
    found from the pre-activations of both runs and left out of the
    max-norm check of that fc's weight and bias (and counted); every
    other element of every gradient is held to GRAD_RTOL of its tensor's
    max |g|."""
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    m["startup"].random_seed = SEED + 5
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(m["startup"], scope=cpu_scope)
    state = {n: cpu_scope[n].numpy() for n in m["main"].persistable_names()
             if n in cpu_scope}
    fluid.load_numpy_state(m["main"], state, scope=card_scope, device=dev)
    feed = make_feeds(np.random.RandomState(SEED + 6), cfg["batch_size"],
                      cfg["seq_len"], cfg["trg_vocab_size"])
    grads = [p.name + "@GRAD"
             for p in m["main"].global_block().all_parameters() if p.trainable]
    gates = relu_gates(m["main"])
    fetch = [m["loss"]] + grads + [pre for pre, _, _ in gates]
    saved = fa.FLASH_BWD_IMPL
    fa.FLASH_BWD_IMPL = engine
    try:
        fa.reset_launch_counts()
        card = fluid.Executor(fluid.CUDAPlace(0)).run(
            m["main"], feed=feed, fetch_list=fetch, scope=card_scope)
        launches = dict(fa.KERNEL_LAUNCHES)
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            m["main"], feed=feed, fetch_list=fetch, scope=cpu_scope)
    finally:
        fa.FLASH_BWD_IMPL = saved
    loss_card, loss_cpu = float(card[0]), float(cpu[0])
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    check(np.isfinite(loss_card) and loss_err <= LOSS_RTOL,
          "card vs cpu loss", loss_card, loss_cpu)
    # units whose ReLU gate differs between the card and the CPU, by the
    # gradient names of their fc weight (columns) and bias (elements)
    flipped, n_flips = {}, 0
    for i, (_, w, b) in enumerate(gates):
        a, r = card[1 + len(grads) + i], cpu[1 + len(grads) + i]
        diff = (a > 0) != (r > 0)
        n_flips += int(diff.sum())
        units = np.nonzero(diff.reshape(-1, diff.shape[-1]).any(0))[0]
        if len(units):
            flipped[w + "@GRAD"] = flipped[b + "@GRAD"] = units
    worst, worst_l2 = 0.0, 0.0
    for name, g, r in zip(grads, card[1:], cpu[1:]):
        check(g.shape == r.shape and np.isfinite(g).all(), name)
        scale = float(np.abs(r).max())
        d = np.abs(g - r)
        worst_l2 = max(worst_l2, float(np.linalg.norm(g - r))
                       / max(float(np.linalg.norm(r)), 1e-30))
        if name in flipped:
            d = d.copy()
            d[..., flipped[name]] = 0.0
        err = float(d.max())
        rel = err / scale if scale > 0 else err
        check(rel <= GRAD_RTOL, "card vs cpu gradient", name, err, scale)
        worst = max(worst, rel)
    check_flash_launches(fa, launches, bwd_engine(fa, engine, cfg), 18,
                         "card-vs-cpu step")
    out = {"engine": engine, "loss_card": loss_card, "loss_cpu": loss_cpu,
           "loss_rel_err": loss_err, "grads": len(grads),
           "worst_grad_err_of_max": worst, "worst_grad_l2_rel": worst_l2,
           "relu_gates": sum(int(np.prod(card[1 + len(grads) + i].shape))
                             for i in range(len(gates))),
           "relu_gate_flips": n_flips,
           "units_left_out": {k: len(v) for k, v in flipped.items()},
           "launches": launches}
    log("train check (card vs cpu, batch %d x %d, dropout 0, engine %s): %s"
        % (cfg["batch_size"], cfg["seq_len"], engine, json.dumps(out)))
    return out


def profile_step(torch, exe, m, feed, scope):
    """Where one training step's device time goes, by kernel family, and
    the device's idle share of the step's wall time; "not measured" when
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(m["main"], feed=feed, fetch_list=[m["loss"]], scope=scope)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return "not measured (the profiler recorded no device activity)"
    flash = {"flash_fwd_kernel": "flash_fwd",
             "flash_bwd_fused_kernel": "flash_bwd_fused",
             "flash_bwd_dq_sum_kernel": "flash_bwd_dq_sum",
             "flash_bwd_delta_kernel": "flash_bwd_delta",
             "flash_bwd_dkv_kernel": "flash_bwd_dkv",
             "flash_bwd_dq_kernel": "flash_bwd_dq"}
    families = dict.fromkeys(list(flash.values()) + ["gemm", "other"], 0.0)
    for e in kernels:
        name = e.name.lower()
        fam = next((f for k, f in flash.items() if k in name), None)
        if fam is None:
            fam = ("gemm" if any(k in name for k in (
                "gemm", "xmma", "cutlass", "gemv", "sm90_", "sm80_"))
                else "other")
        families[fam] += e.time_range.elapsed_us()
    busy = sum(families.values())
    return {"step_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_family": {k: v / 1e3 for k, v in families.items()},
            "device_events": len(kernels)}


def train_phase(torch, fluid, T, fa, dev, cfg, steps, engine, label):
    """Transformer-base trains through Executor.run on the card, with the
    flash backward engine ``engine``."""
    with fluid.unique_name.guard():
        m = T.get_model(**cfg)
    m["startup"].random_seed = SEED + 7
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(m["startup"], scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    params = [p.name for p in m["main"].global_block().all_parameters()]
    trainable = [p.name for p in m["main"].global_block().all_parameters()
                 if p.trainable]
    n_values = sum(scope[p].numel() for p in params)
    before = {p: scope[p].clone() for p in trainable}
    rng = np.random.RandomState(SEED + 8)
    feeds = [make_feeds(rng, cfg["batch_size"], cfg["seq_len"],
                        cfg["trg_vocab_size"])
             for _ in range(steps + 1)]
    saved = fa.FLASH_BWD_IMPL
    fa.FLASH_BWD_IMPL = engine
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.reset_launch_counts()
        losses, step_s = [], []
        for feed in feeds[:steps]:
            t0 = time.perf_counter()
            (loss,) = exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                              scope=scope)  # the numpy fetch waits for it
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = dict(fa.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        check(all(np.isfinite(losses)), "non-finite loss", losses)
        for p in trainable:
            check(bool(torch.isfinite(scope[p]).all()), "non-finite param", p)
            check(not torch.equal(scope[p], before[p]), "param did not move",
                  p)
        del before
        ran = bwd_engine(fa, engine, cfg)
        check_flash_launches(fa, launches, ran, 18 * steps, label)
        profile = profile_step(torch, exe, m, feeds[steps], scope)
    finally:
        fa.FLASH_BWD_IMPL = saved
    steady = float(np.mean(step_s[1:]))
    tokens = cfg["batch_size"] * cfg["seq_len"]
    stats = {"params": len(params), "param_values": int(n_values),
             "steps": steps, "engine": engine, "engine_ran": ran,
             "startup_s": startup_s,
             "first_step_ms": step_s[0] * 1e3, "step_ms": steady * 1e3,
             "step_ms_all": [t * 1e3 for t in step_s],
             "target_tokens_per_s": tokens / steady,
             "peak_memory_gib": peak / 2 ** 30, "losses": losses,
             "launches": launches, "profile": profile}
    log("training %s (Transformer-base, batch %d x %d, vocab %d, dropout "
        "0.1): %s" % (label, cfg["batch_size"], cfg["seq_len"],
                      cfg["trg_vocab_size"], json.dumps(stats)))
    return stats


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch import cuda_kernels, observability as obs
        from paddle_tpu_torch import serving
        from paddle_tpu_torch.models import transformer as T
        from paddle_tpu_torch.parallel import flash_attention as fa
    except ImportError as exc:
        print("chip_smoke: the paddle_tpu_torch package is not beside this "
              "script (%s)" % exc, file=sys.stderr)
        return 3
    check("jax" not in sys.modules and not any(
        m == "paddle_tpu" or m.startswith("paddle_tpu.") for m in sys.modules),
        "chip_smoke imported jax or paddle_tpu")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card: %s | torch %s, CUDA %s | allow_tf32 matmul=%s cudnn=%s"
        % (card, torch.__version__, torch.version.cuda,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))

    cuda_kernels.load_library()
    info = cuda_kernels.build_info()
    log("build: %.2f s (%s)" % (info["seconds"], "built" if info["built"]
                                else "reused %s" % info["path"]))
    for name, regs, spill in ptxas_report(info["log"]):
        log("  ptxas: %s: %d registers, %d bytes spilled" % (name, regs, spill))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    dec = decode_phase(torch, fa, dev, flush)
    pre = prefill_phase(torch, fa, dev, flush)
    flash_cases, flash_times = flash_phase(torch, fa, dev, flush)
    pair_cases = pair_phase(torch, fa, dev)
    sweep = engine_sweep(torch, fa, dev, flush)
    del flush
    srv = serving_phase(torch, T, serving, fa, obs, dev)
    torch.cuda.empty_cache()
    # card vs CPU: B2 at batch 2 x 64, B3 at batch 2 x 200
    fused_check = train_check_phase(torch, fluid, T, fa, dev, CHECK_CFG,
                                    "fused")
    pair_check = train_check_phase(torch, fluid, T, fa, dev, PAIR_CHECK_CFG,
                                   "pair")
    trn = train_phase(torch, fluid, T, fa, dev, TRAIN_CFG, TRAIN_STEPS,
                      "auto", "64 x 256")
    torch.cuda.empty_cache()
    lng = train_phase(torch, fluid, T, fa, dev, LONG_CFG, LONG_STEPS,
                      "auto", "4 x 4096")

    # each backward engine's main path: the first training leg that auto
    # runs it on, else the full-width card-vs-CPU step that runs it by name
    b2_path, b3_path = (
        next((t for t in (trn, lng) if t["engine_ran"] == engine), step)
        for engine, step in (("fused", fused_check), ("pair", pair_check)))
    d32 = next(r for r in dec if r["dtype"] == "float32")
    p32 = next(r for r in pre if r["dtype"] == "float32"
               and (r["start"], r["C"]) == PREFILL_TIMED[0])
    full = next(t for t in flash_times if not t["causal"])
    # the long leg's shape, not causal.  No single PyTorch call computes
    # dk/dv alone or dq alone, so their library_ms is null; the pair as a
    # whole stands beside SDPA's autograd backward (dq, dk and dv)
    longest = next(r for r in sweep
                   if tuple(r["shape"]) == SWEEP_SHAPES[3] and not r["causal"])
    pair_vs_library = {"pair_ms": longest["pair_dev_ms"],
                       "pair_library_ms": longest["sdpa_bwd_ms"],
                       "pair_library": "scaled_dot_product_attention "
                                       "autograd backward (dq, dk, dv)"}
    pair_rows = {
        "flash_attention_bwd_dkv": {
            "ms": longest["dkv_ms"], "plain_ms": longest["dkv_plain_ms"],
            "bound": longest["dkv_bound"], "library_ms": None},
        "flash_attention_bwd_dq": {
            "ms": longest["dq_ms"], "plain_ms": longest["dq_plain_ms"],
            "bound": longest["dq_bound"], "library_ms": None}}
    # B1 at the long leg's shape, not causal (device time from the sweep's
    # profiler window), and its launches on the long leg
    fwd_long = {"long_shape": list(SWEEP_SHAPES[3]),
                "long_ms": longest["fwd_dev_ms"],
                "long_plain_ms": longest["fwd_plain_ms"],
                "long_bound_ms": longest["fwd_bound"][0],
                "long_library_ms": longest["sdpa_fwd_ms"],
                "long_launches": lng["launches"]["flash_attention_fwd"]}
    # B2 at the same shape: device time of its three launches, the dq sum's
    # share apart, and its launches on the long leg (0 unless auto runs it)
    bwd_long = {"long_shape": list(SWEEP_SHAPES[3]),
                "long_ms": longest["b2_dev_ms"],
                "long_fused_ms": longest["b2_fused_ms"],
                "long_dq_sum_ms": longest["b2_dq_sum_ms"],
                "long_plain_ms": longest["b2_plain_ms"],
                "long_bound_ms": longest["bound"][0],
                "long_library_ms": longest["sdpa_bwd_ms"],
                "long_launches": lng["launches"]["flash_attention_bwd"]}
    f32_pairs = [c for c in pair_cases if c["dtype"] == "float32"]
    sweep_errs = lambda key: [r["errs"][key] for r in sweep]  # noqa: E731
    kernels = []
    for name, launches, row, replaces, src, errs in (
            ("flash_attention_fwd", trn["launches"], full["fwd"],
             "paddle_tpu/parallel/flash_attention.py:73",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["fwd_err"] for c in flash_cases if c["dtype"] == "float32"]
             + sweep_errs("fwd")),
            ("flash_attention_bwd", b2_path["launches"], full["bwd"],
             "paddle_tpu/parallel/flash_attention.py:513",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["bwd_err"] for c in flash_cases if c["dtype"] == "float32"]
             + sweep_errs("b2")),
            ("flash_attention_bwd_dkv", b3_path["launches"],
             pair_rows["flash_attention_bwd_dkv"],
             "paddle_tpu/parallel/flash_attention.py:288",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["dkv_err"] for c in f32_pairs] + sweep_errs("dkv")),
            ("flash_attention_bwd_dq", b3_path["launches"],
             pair_rows["flash_attention_bwd_dq"],
             "paddle_tpu/parallel/flash_attention.py:328",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["dq_err"] for c in f32_pairs] + sweep_errs("dq")),
            ("paged_decode_attention", srv["launches"], d32,
             "paddle_tpu/parallel/flash_attention.py:848",
             "paddle_tpu_torch/csrc/paged_attention.cu",
             [r["max_abs_err"] for r in dec]),
            ("paged_prefill_attention", srv["launches"], p32,
             "paddle_tpu/parallel/flash_attention.py:991",
             "paddle_tpu_torch/csrc/paged_attention.cu",
             [r["max_abs_err"] for r in pre])):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["library_ms"]})
        if name in pair_rows:
            kernels[-1].update(pair_vs_library)
        if name == "flash_attention_fwd":
            kernels[-1].update(fwd_long)
        if name == "flash_attention_bwd":
            kernels[-1].update(bwd_long)
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel was not launched on its main path", kernels)
    log("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
