#!/usr/bin/env python3
"""Which CUDA streams the live replicas of two decode pools hold, and
what device memory a stopped pool keeps, through the cycle a model
router's LRU tier runs in one process: one two-replica pool stays warm
and serves while a second two-replica pool is built, serves a few
requests and is stopped, again and again.

    python3 tools/stream_probe.py [--root DIR] [--cycles N]

``--root`` imports ``paddle_tpu_torch`` from another checkout (a parent
commit unpacked into a gitignored directory) to compare two trees in one
call.  For every cycle it prints one JSON line: each live holder's
stream handle (a replica's worker stream, its load streams, the capture
side stream of each), the handles the new pool shares with the warm
pool, and ``memory_allocated`` / ``memory_reserved`` before the build,
after ``stop()`` and after ``gc.collect()`` and ``empty_cache()``.  The
last line sums them up.  The LM is chip_smoke's serving width cut to two
layers (the streams do not depend on the depth); it needs the card and
builds the kernels first.
"""
import argparse
import gc
import json
import os
import sys
import threading

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WIDTH = dict(vocab_size=32000, n_layer=2, n_head=8, d_model=512,
             d_inner=2048, max_length=2048)
CONFIG = dict(num_slots=8, page_size=16, max_seq_len=2048,
              max_new_tokens=256)


def side_stream(torch, executor, index, stream):
    """The capture side stream of ``stream``, where one was made."""
    try:
        from paddle_tpu_torch import streams
    except ImportError:    # a tree without the lease
        return executor._CAPTURE_STREAMS.get((index, stream.cuda_stream))
    side = streams.side_of(index, stream)
    if side is None:
        side = executor._CAPTURE_STREAMS.get((index, stream.cuda_stream))
    return side


def holders(torch, executor, pool, tag):
    """(holder, handle) of every stream a live replica of ``pool`` holds."""
    out = []
    for r in pool._replicas:
        own = [("worker", r.stream)] + [
            ("load%d" % j, s) for j, s in enumerate(r._load_streams)
            if s is not None]
        for role, s in own:
            out.append(("%s.r%d.%s" % (tag, r.index, role), s.cuda_stream))
            side = side_stream(torch, executor, r.device.index or 0, s)
            if side is not None:
                out.append(("%s.r%d.%s-side" % (tag, r.index, role),
                            side.cuda_stream))
    return out


def memory(torch, dev):
    return {"allocated": torch.cuda.memory_allocated(dev),
            "reserved": torch.cuda.memory_reserved(dev)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--cycles", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("stream_probe: needs a CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch import cuda_kernels, executor, serving
    from paddle_tpu_torch.models import transformer as T

    cuda_kernels.load_library()
    dev = torch.device("cuda", 0)
    params, meta = T.lm_params(seed=0, **WIDTH)
    model = T.build_decode_model(params, meta, device=dev)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, WIDTH["vocab_size"], size=int(n))
               .astype(np.int32) for n in rng.randint(32, 300, size=8)]

    def pool():
        return serving.ReplicaPool(
            None, replicas=2, devices=[dev], decode_model=model,
            decode_config=serving.DecodeConfig(**CONFIG))

    warm = pool()
    want = [warm.generate(p, max_new_tokens=16, timeout=600)
            for p in prompts]
    stop, errors, served = threading.Event(), [], [0]

    def traffic():
        i = 0
        try:
            while not stop.is_set():
                out = warm.generate(prompts[i % 8], max_new_tokens=16,
                                    timeout=600)
                if out.tobytes() != want[i % 8].tobytes():
                    errors.append("warm pool request %d differs" % i)
                served[0] += 1
                i += 1
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))

    t = threading.Thread(target=traffic)
    t.start()
    warm_holders = holders(torch, executor, warm, "warm")
    cycles = []
    try:
        for cycle in range(args.cycles):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = memory(torch, dev)
            cold = pool()
            got = [cold.generate(p, max_new_tokens=16, timeout=600)
                   for p in prompts[:4]]
            bad = sum(g.tobytes() != w.tobytes()
                      for g, w in zip(got, want))
            mine = holders(torch, executor, cold, "cold%d" % cycle)
            live = dict((h, n) for n, h in warm_holders)
            shared = [(n, live[h]) for n, h in mine if h in live]
            handles = [h for _, h in warm_holders + mine]
            cold.stop()
            torch.cuda.synchronize()
            stopped = memory(torch, dev)
            del cold
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            collected = memory(torch, dev)
            row = {"cycle": cycle, "holders": mine,
                   "shared_with_warm": shared,
                   "distinct_live_handles": len(set(handles)),
                   "live_holders": len(handles),
                   "tokens_differ": bad, "memory_before": before,
                   "memory_after_stop": stopped,
                   "memory_after_collect": collected}
            cycles.append(row)
            print(json.dumps(row), flush=True)
    finally:
        stop.set()
        t.join()
        warm.stop()
    print(json.dumps({
        "root": os.path.abspath(args.root),
        "warm_holders": warm_holders,
        "first_cycle_sharing": next(
            (r["cycle"] for r in cycles if r["shared_with_warm"]), None),
        "cycles_sharing": sum(1 for r in cycles if r["shared_with_warm"]),
        "allocated_kept_after_stop_mib": [
            (r["memory_after_stop"]["allocated"]
             - r["memory_before"]["allocated"]) / 2 ** 20 for r in cycles],
        "allocated_kept_after_collect_mib": [
            (r["memory_after_collect"]["allocated"]
             - r["memory_before"]["allocated"]) / 2 ** 20 for r in cycles],
        "warm_requests_served": served[0], "errors": errors[:4],
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
