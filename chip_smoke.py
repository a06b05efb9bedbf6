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
   chunk-split bitwise equal to one call), then the kernel's time, the
   plain version's, the least time the card could take (bound), and one
   PyTorch library call for the same work as a yardstick;
4. the flash attention kernels (forward B1, fused backward B2) at the
   training slice's shape [64, 8, 256, 64], in float32 and bfloat16, on
   strided q/k/v/do views as the Program feeds them, with mixed kv_lens
   (zeros included): against their plain versions (forward out and lse
   <= 2e-5, backward <= 5e-5 absolute in float32; in bfloat16 <= 1e-2 of
   max(1, |value|), since one bf16 rounding grows with the value) for causal
   and not causal, causal T < S and an uneven tail (T = 200); rows with
   kv_lens 0 give zero out and zero, finite gradients; NaN/Inf written
   past kv_lens leaves every output bitwise unchanged; two backward calls
   give the same bits; then each kernel's time beside its plain
   version's, its bound and a scaled_dot_product_attention yardstick
   (its autograd backward for B2);
5. serving: the Transformer LM at the documented decode width
   (vocab 32000, 12 layers, 8 heads, d_model 512, d_inner 2048, random
   weights from a seed) through InferenceEngine.generate: 16 concurrent
   greedy requests, prompts of 32-1500 tokens, 64 new tokens each.  Both
   paged kernels' launch counts must move by layers x steps, and a few
   requests must come out bitwise equal from a max_active=1 engine;
   the LM's logits on the card are held against the plain CPU versions
   on a short input; a short profiled window then splits the device
   time by kernel family and gives the device's idle share;
6. training, card vs CPU: Transformer-base at full width (6+6 layers,
   d_model 512, vocab 30000; batch 2 x 64, dropout 0) from one set of
   numpy parameters: one step's loss (1e-4 relative) and every
   <param>@GRAD (1e-3 of that tensor's max |g|; the few fc units whose
   ReLU gate opens on one side only are found and left out of their own
   fc's weight and bias check, and counted) through Executor.run on the
   card against the port's plain CPU path; its flash launches are
   counted apart from the main path's;
7. training: Transformer-base as the JAX package's headline leg
   (bench.py: batch 64 x 256, vocab 30000, dropout 0.1, Adam with noam
   decay, use_flash=True, float32 with TF32 off) through
   Executor.run(startup) and 10 Executor.run(main) steps on seeded token
   feeds whose rows have their own lengths (64-256, pad tails): every
   loss finite, every parameter finite and moved, and both flash
   kernels launched 18 times a step; step time, target tokens/s, peak
   memory, the loss trajectory, and a profiled step split by kernel
   family with the device's idle share;
8. a ``kernels`` JSON line, the card line, and the final
   ``{"ok": true, "device": {...}}`` line.

It needs the repository beside it and a CUDA device; without either it
exits non-zero before printing any result.
"""
import json
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


def time_ms(fn, iters, flush):
    """Mean device time of ``fn`` in ms over ``iters`` launches, each
    timed alone by CUDA events with the L2 cache flushed before it (the
    main path reaches each layer's pool cold)."""
    import torch

    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for a, b in zip(starts, ends):
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / iters


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    cases = [(0, 16), (0, 512), (256, 256), (1024, 1024), (0, 2048)]
    timed_case = (0, 1024)
    rows = []
    for dtype, (k, v) in make_pools(torch, dev, gen).items():
        for start, C in cases + [timed_case]:
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
            row = {"dtype": dtype, "start": start, "C": C,
                   "max_abs_err": err, "split_bitwise": True}
            if (start, C) == timed_case:
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
        log("prefill %-8s start=%d C=%d err=%.3g (tol %g) split bitwise%s"
            % (r["dtype"], r["start"], r["C"], r["max_abs_err"], KERNEL_TOL,
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


def flash_inputs(torch, dev, gen, dtype, T, S):
    """q, k, v, do as the Program feeds them: [B, H, T, D] views of
    [B, T, H, D] tensors (strided, last dimension contiguous)."""
    def view(n, scale=1.0):
        x = torch.randn((FB, n, FH, FD), generator=gen, device=dev) * scale
        return x.to(dtype).transpose(1, 2)
    return view(T), view(S), view(S), view(T, 0.1)


def flash_lens(rng, S, with_zeros):
    """kv_lens [FB]: the training feeds' lengths (64..S), or mixed lengths
    with empty, single-key and full rows."""
    if not with_zeros:
        return rng.randint(min(64, S), S + 1, size=FB).astype(np.int32)
    lens = rng.randint(1, S + 1, size=FB).astype(np.int32)
    lens[[0, 5, 9]] = 0
    lens[1], lens[2], lens[3] = 1, S, 17
    return lens


def visible_pairs(lens, T, S, causal):
    """(query, key) pairs the mask leaves visible, summed over the batch
    and heads (what the kernels compute for these kv_lens)."""
    total = 0
    for n in lens:
        if causal:
            rows = np.arange(T) + (S - T) + 1   # keys each row may see
            total += int(np.minimum(rows, n).clip(0).sum())
        else:
            total += T * int(n)
    return total * FH


def flash_bounds(lens, T, S, causal, itemsize):
    pairs = visible_pairs(lens, T, S, causal)
    q_el, kv_el = FB * FH * T * FD, FB * FH * S * FD
    fwd_bytes = (q_el + 2 * kv_el) * itemsize + FB * 4 \
        + q_el * itemsize + FB * FH * T * 4
    bwd_bytes = (3 * q_el + 2 * kv_el) * itemsize + FB * FH * T * 4 + FB * 4 \
        + (q_el + 2 * kv_el) * itemsize
    return (bound_ms(fwd_bytes, 4 * FD * pairs),
            bound_ms(bwd_bytes, 10 * FD * pairs))


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

    def err(a, r):
        # float32: absolute.  bfloat16: absolute up to |value| 1, relative
        # above it — one rounding to bf16 costs up to 2**-9 of the value
        d = (a.float() - r.float()).abs()
        if dtype == "bfloat16":
            d = d / r.float().abs().clamp_min(1.0)
        return d.max().item()

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
        for causal, T, S, nan_check in ((False, FT, FT, True),
                                        (True, FT, FT, True),
                                        (True, 128, FT, False),
                                        (False, 200, 200, False),
                                        (True, 200, 200, False)):
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


def train_check_phase(torch, fluid, T, fa, dev):
    """One training step on the card against the port's plain CPU path,
    from the same numpy parameters, at full width (batch 2 x 64).

    A ReLU gate whose pre-activation lies within rounding of 0 may open
    on one side and stay shut on the other; that moves its unit's column
    of the fc weight gradient (and bias element) by one token's whole
    contribution, which no summation tolerance covers.  Such units are
    found from the pre-activations of both runs and left out of the
    max-norm check of that fc's weight and bias (and counted); every
    other element of every gradient is held to GRAD_RTOL of its tensor's
    max |g|."""
    with fluid.unique_name.guard():
        m = T.get_model(**CHECK_CFG)
    m["startup"].random_seed = SEED + 5
    cpu_scope, card_scope = fluid.Scope(), fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(m["startup"], scope=cpu_scope)
    state = {n: cpu_scope[n].numpy() for n in m["main"].persistable_names()
             if n in cpu_scope}
    fluid.load_numpy_state(m["main"], state, scope=card_scope, device=dev)
    feed = make_feeds(np.random.RandomState(SEED + 6),
                      CHECK_CFG["batch_size"], CHECK_CFG["seq_len"],
                      CHECK_CFG["trg_vocab_size"])
    grads = [p.name + "@GRAD"
             for p in m["main"].global_block().all_parameters() if p.trainable]
    gates = relu_gates(m["main"])
    fetch = [m["loss"]] + grads + [pre for pre, _, _ in gates]
    before = dict(fa.KERNEL_LAUNCHES)
    card = fluid.Executor(fluid.CUDAPlace(0)).run(
        m["main"], feed=feed, fetch_list=fetch, scope=card_scope)
    launches = {n: fa.KERNEL_LAUNCHES[n] - before[n] for n in before}
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        m["main"], feed=feed, fetch_list=fetch, scope=cpu_scope)
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
    check(launches["flash_attention_fwd"] == launches["flash_attention_bwd"]
          == 18, "card-vs-cpu step flash launches", launches)
    out = {"loss_card": loss_card, "loss_cpu": loss_cpu,
           "loss_rel_err": loss_err, "grads": len(grads),
           "worst_grad_err_of_max": worst, "worst_grad_l2_rel": worst_l2,
           "relu_gates": sum(int(np.prod(card[1 + len(grads) + i].shape))
                             for i in range(len(gates))),
           "relu_gate_flips": n_flips,
           "units_left_out": {k: len(v) for k, v in flipped.items()},
           "launches": launches}
    log("train check (card vs cpu, batch %d x %d, dropout 0): %s"
        % (CHECK_CFG["batch_size"], CHECK_CFG["seq_len"], json.dumps(out)))
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
    families = {"flash_fwd": 0.0, "flash_bwd": 0.0, "gemm": 0.0,
                "other": 0.0}
    for e in kernels:
        name = e.name.lower()
        if "flash_fwd_kernel" in name:
            fam = "flash_fwd"
        elif "flash_bwd_kernel" in name:
            fam = "flash_bwd"
        elif any(k in name for k in ("gemm", "xmma", "cutlass", "gemv",
                                     "sm90_", "sm80_")):
            fam = "gemm"
        else:
            fam = "other"
        families[fam] += e.time_range.elapsed_us()
    busy = sum(families.values())
    return {"step_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us),
            "device_ms_by_family": {k: v / 1e3 for k, v in families.items()},
            "device_events": len(kernels)}


def train_phase(torch, fluid, T, fa, dev):
    """Transformer-base trains through Executor.run on the card."""
    with fluid.unique_name.guard():
        m = T.get_model(**TRAIN_CFG)
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
    feeds = [make_feeds(rng, TRAIN_CFG["batch_size"], TRAIN_CFG["seq_len"],
                        TRAIN_CFG["trg_vocab_size"])
             for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    losses, step_s = [], []
    for feed in feeds[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        (loss,) = exe.run(m["main"], feed=feed, fetch_list=[m["loss"]],
                          scope=scope)   # the numpy fetch waits for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = dict(fa.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)), "non-finite loss", losses)
    for p in trainable:
        check(bool(torch.isfinite(scope[p]).all()), "non-finite param", p)
        check(not torch.equal(scope[p], before[p]), "param did not move", p)
    del before
    check(launches["flash_attention_fwd"] == launches["flash_attention_bwd"]
          == 18 * TRAIN_STEPS, "training flash launches", launches)
    profile = profile_step(torch, exe, m, feeds[TRAIN_STEPS], scope)
    steady = float(np.mean(step_s[1:]))
    tokens = TRAIN_CFG["batch_size"] * TRAIN_CFG["seq_len"]
    stats = {"params": len(params), "param_values": int(n_values),
             "steps": TRAIN_STEPS, "startup_s": startup_s,
             "first_step_ms": step_s[0] * 1e3, "step_ms": steady * 1e3,
             "step_ms_all": [t * 1e3 for t in step_s],
             "target_tokens_per_s": tokens / steady,
             "peak_memory_gib": peak / 2 ** 30, "losses": losses,
             "launches": launches, "profile": profile}
    log("training (Transformer-base, batch %d x %d, vocab %d, dropout 0.1): %s"
        % (TRAIN_CFG["batch_size"], TRAIN_CFG["seq_len"],
           TRAIN_CFG["trg_vocab_size"], json.dumps(stats)))
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
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    dec = decode_phase(torch, fa, dev, flush)
    pre = prefill_phase(torch, fa, dev, flush)
    flash_cases, flash_times = flash_phase(torch, fa, dev, flush)
    del flush
    srv = serving_phase(torch, T, serving, fa, obs, dev)
    torch.cuda.empty_cache()
    train_check_phase(torch, fluid, T, fa, dev)
    trn = train_phase(torch, fluid, T, fa, dev)

    d32 = next(r for r in dec if r["dtype"] == "float32")
    p32 = next(r for r in pre if r["dtype"] == "float32" and "ms" in r)
    full = next(t for t in flash_times if not t["causal"])
    kernels = []
    for name, launches, row, replaces, src, errs in (
            ("flash_attention_fwd", trn["launches"], full["fwd"],
             "paddle_tpu/parallel/flash_attention.py:73",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["fwd_err"] for c in flash_cases if c["dtype"] == "float32"]),
            ("flash_attention_bwd", trn["launches"], full["bwd"],
             "paddle_tpu/parallel/flash_attention.py:513",
             "paddle_tpu_torch/csrc/flash_attention.cu",
             [c["bwd_err"] for c in flash_cases if c["dtype"] == "float32"]),
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
    log("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
