#!/usr/bin/env python3
"""Probes of conversational sessions on one CUDA card, for what
chip_smoke.py does not run alone.

    python3 tools/sessions_probe.py pages   # the page-bits probe: a
                                            # decode-written page's KV
                                            # bits against a cold prefill
                                            # of the same history
    python3 tools/sessions_probe.py phase   # chip_smoke's sessions phase
                                            # alone; its result as the
                                            # last line
    python3 tools/sessions_probe.py handoff # a roles pool (prefill,
                                            # decode, decode) over the
                                            # phase's conversations twice:
                                            # each pass's handoff legs and
                                            # the device segments it made
                                            # (by replica stream), the
                                            # gather's parts timed under
                                            # the load (and what a fresh
                                            # event would cost), then
                                            # alone

All three run the serving LM at chip_smoke's width (random weights from its
seed), need the card and build the kernels first (about 30 s).
"""
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as c  # noqa: E402


def segments(torch, dev):
    """The caching allocator's segments: address -> (bytes, stream)."""
    return {seg["address"]: (seg["total_size"], seg["stream"])
            for seg in torch.cuda.memory_snapshot()
            if seg["device"] == dev.index}


def handoff(torch, T, serving, obs, dev):
    params, meta = T.lm_params(seed=c.SEED, **c.LM_WIDTH)
    model = T.build_decode_model(params, meta, device=dev)
    firsts, later = c.session_traffic(meta)
    pool = serving.ReplicaPool(
        None, replicas=c.SESSION_REPLICAS, devices=[dev],
        decode_model=model, decode_config=serving.DecodeConfig(
            **dict(c.DECODE_CONFIG, prefix_cache=True)),
        roles=c.SESSION_ROLES)
    names = {r.stream.cuda_stream: "replica%d" % r.index
             for r in pool._replicas}
    # the prefill replica's gather, its parts timed under the load
    sched0 = pool._replicas[0].decoder
    split = []

    def timed_gather(pages):
        cache = sched0._cache
        host = (torch.cuda.host_memory_stats().get("host_alloc_time.count")
                if hasattr(torch.cuda, "host_memory_stats") else None)
        with torch.no_grad():
            t = [time.perf_counter()]
            idx = torch.tensor(pages, dtype=torch.long, device=dev)
            t.append(time.perf_counter())
            k = torch.index_select(cache.k_pool, 1, idx)
            v = torch.index_select(cache.v_pool, 1, idx)
            t.append(time.perf_counter())
            k_host = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
            v_host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            t.append(time.perf_counter())
            k_host.copy_(k, non_blocking=True)
            t.append(time.perf_counter())
            v_host.copy_(v, non_blocking=True)
            t.append(time.perf_counter())
            if sched0._copied is None:
                sched0._copied = torch.cuda.Event()
            sched0._copied.record()
            t.append(time.perf_counter())
            sched0._copied.synchronize()
            t.append(time.perf_counter())
            time.sleep(0)                # a bare release of the GIL
            t.append(time.perf_counter())
            torch.cuda.Event().record()  # what a fresh event a gather costs
            t.append(time.perf_counter())
        split.append([len(pages)] + [(b - a) * 1e3 for a, b in zip(t, t[1:])]
                     + [None if host is None else torch.cuda
                        .host_memory_stats()["host_alloc_time.count"]
                        - host])
        return k_host, v_host

    sched0._hgather = timed_gather
    legs = {n: obs.timer("serving.handoff.stage", labels={"leg": n})
            for n in ("gather", "scatter")}
    rows = []
    for n in range(2):
        torch.cuda.synchronize()
        before, reserved0 = segments(torch, dev), \
            torch.cuda.memory_reserved(dev)
        g0 = {k: (t.count, t.total) for k, t in legs.items()}
        t0 = time.perf_counter()
        _, turns = c.run_conversations(obs, pool, firsts, later,
                                       key="p%d_%%d" % n)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        new = [(size, names.get(stream, stream))
               for addr, (size, stream) in segments(torch, dev).items()
               if addr not in before]
        rows.append({
            "pass": n, "wall_s": wall,
            "ttft_p50_ms": [t["ttft_p50_ms"] for t in turns],
            "legs_mean_ms": {k: (t.total - g0[k][1]) * 1e3
                             / max(1, t.count - g0[k][0])
                             for k, t in legs.items()},
            "reserved_added_mib":
            (torch.cuda.memory_reserved(dev) - reserved0) / 2 ** 20,
            "new_segments": new})
        parts = np.array([r[1:10] for r in split], np.float64)
        names_ = ("index", "select", "pin_alloc", "copy_k", "copy_v",
                  "event", "wait", "gil_release", "fresh_event")
        rows[-1]["gather_parts_mean_ms"] = dict(zip(
            names_, parts.mean(0).tolist()))
        rows[-1]["gather_parts_p50_ms"] = dict(zip(
            names_, np.median(parts, 0).tolist()))
        rows[-1]["gather_parts_max_ms"] = dict(zip(
            names_, parts.max(0).tolist()))
        rows[-1]["host_allocs"] = sum(r[10] or 0 for r in split)
        split.clear()
        c.log("handoff pass %d: %s" % (n, json.dumps(rows[-1])))
    del sched0._hgather
    # the gather's parts alone, on the prefill replica's stream: its
    # index upload, index_select, pinned allocation, copy and wait
    rep = pool._replicas[0]
    sched, cache = rep.decoder, rep.decoder._cache
    parts = []
    with torch.cuda.stream(rep.stream), torch.no_grad():
        for n_pages in (24, 36, 48, 36, 36):
            pages = list(range(1, n_pages + 1))
            t = [time.perf_counter()]
            idx = torch.tensor(pages, dtype=torch.long, device=dev)
            t.append(time.perf_counter())
            k = torch.index_select(cache.k_pool, 1, idx)
            v = torch.index_select(cache.v_pool, 1, idx)
            t.append(time.perf_counter())
            k_host = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
            v_host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            t.append(time.perf_counter())
            k_host.copy_(k, non_blocking=True)
            v_host.copy_(v, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            t.append(time.perf_counter())
            ev.synchronize()
            t.append(time.perf_counter())
            whole0 = time.perf_counter()
            sched._hgather(pages)
            whole = time.perf_counter() - whole0
            parts.append({"pages": n_pages, "mb": 2 * k.nbytes / 1e6,
                          "ms": dict(zip(
                              ("index", "select", "pin_alloc", "copy_enq",
                               "wait"),
                              [(b - a) * 1e3 for a, b in zip(t, t[1:])])),
                          "hgather_ms": whole * 1e3})
            del k_host, v_host
    pool.stop()
    out = {"passes": rows, "gather_parts": parts}
    if hasattr(torch.cuda, "host_memory_stats"):
        out["host_memory_stats"] = {
            k: v for k, v in torch.cuda.host_memory_stats().items()
            if "current" in k or "peak" in k or "count" in k}
    return out


def main():
    import torch

    which = sys.argv[1:2] or ["pages"]
    if which[0] not in ("pages", "phase", "handoff"):
        sys.exit("usage: sessions_probe.py pages|phase|handoff")
    if not torch.cuda.is_available():
        sys.exit("sessions_probe.py needs a CUDA device")
    from paddle_tpu_torch import cuda_kernels, observability as obs, serving
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import flash_attention as fa

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.log("card: %s | torch %s, CUDA %s" % (
        c.card_line(), torch.__version__, torch.version.cuda))
    cuda_kernels.load_library()
    if which[0] == "pages":
        params, meta = T.lm_params(seed=c.SEED, **c.LM_WIDTH)
        model = T.build_decode_model(params, meta, device=dev)
        out = c.page_bits_probe(torch, serving, dev, model, meta)
    elif which[0] == "phase":
        out = c.sessions_phase(torch, T, serving, fa, obs, dev)
    else:
        out = handoff(torch, T, serving, obs, dev)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
