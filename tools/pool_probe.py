#!/usr/bin/env python3
"""Probes of the replica pool on one CUDA card, for what chip_smoke.py
does not print whole.

    python3 tools/pool_probe.py phases   # chip_smoke's serving phase, then
                                         # its pool phase; the pool's
                                         # result as the last line
    python3 tools/pool_probe.py swap     # a 2-replica predict pool of
                                         # Transformer-base scoring swapped
                                         # v1 -> v2 (under four clients)
                                         # -> v1 -> v2 -> v1

``swap`` prints, after each swap, the memory reserved and allocated, the
inactive split bytes and the segment counts (each read after
``empty_cache``), and the segments that hold both live and free blocks
by the stream they belong to: where a rolling swap's reserved memory
goes.  Both need the card and build the kernels first (about 30 s).
"""
import gc
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as c  # noqa: E402


def phases(torch, dev):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observability as obs, serving
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import flash_attention as fa

    _, prompts, outs = c.serving_phase(torch, T, serving, fa, obs, dev)
    root = tempfile.mkdtemp(prefix="pool_probe_")
    saved = c.save_predict_models(torch, fluid, T, root)
    try:
        pool = c.pool_phase(torch, T, serving, fa, obs, dev, prompts, outs,
                            saved)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(pool, default=str))


def memory(torch, dev, tag, pool=None):
    """The card's memory after ``empty_cache``, and the segments of the
    caching allocator holding live and free blocks (by stream)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    st = torch.cuda.memory_stats(dev)
    row = {"tag": tag,
           "reserved_mb": torch.cuda.memory_reserved(dev) / 2 ** 20,
           "allocated_mb": torch.cuda.memory_allocated(dev) / 2 ** 20,
           "inactive_split_mb":
           st.get("inactive_split_bytes.all.current", 0) / 2 ** 20,
           "segments": st.get("segment.all.current"),
           "large_segments": st.get("segment.large_pool.current"),
           "small_segments": st.get("segment.small_pool.current")}
    if pool is not None:
        names = {}
        for r in pool._replicas:
            names[r.stream.cuda_stream] = "rep%d" % r.index
            for j, s in enumerate(r._load_streams):
                if s is not None:   # leased at a replica's first load
                    names[s.cuda_stream] = "rep%d-load%d" % (r.index, j)
        split = []
        for seg in torch.cuda.memory_snapshot():
            free = seg["total_size"] - seg["allocated_size"]
            if seg["allocated_size"] and free > 2 ** 20:
                live = sorted((b["size"] for b in seg["blocks"]
                               if b["state"] == "active_allocated"),
                              reverse=True)
                split.append({"stream": names.get(seg["stream"],
                                                  seg["stream"]),
                              "mb": seg["total_size"] >> 20,
                              "free_mb": free >> 20,
                              "live_kb": [n >> 10 for n in live[:6]],
                              "live_blocks": len(live)})
        row["split_segments"] = sorted(split, key=lambda x: -x["free_mb"])
    c.log("memory " + json.dumps(row))
    return row


def swap(torch, dev):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import transformer as T

    root = tempfile.mkdtemp(prefix="pool_probe_")
    try:
        swap_rows(torch, dev, fluid, serving, T, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def swap_rows(torch, dev, fluid, serving, T, root):
    d1, d2 = os.path.join(root, "v1"), os.path.join(root, "v2")
    c.save_predict_model(fluid, T, d1, c.SEED + 50, aot=False)
    c.save_predict_model(fluid, T, d2, c.SEED + 51, aot=False)
    vocab, seq = c.TRAIN_CFG["trg_vocab_size"], c.TRAIN_CFG["seq_len"]
    rng = np.random.RandomState(c.SEED + 60)
    feeds = [c.predict_feed(*c.predict_rows(rng, int(n), seq, vocab))
             for n in rng.randint(1, 3, size=16)]
    rows = [memory(torch, dev, "start")]
    pool = serving.ReplicaPool(d1, replicas=2, devices=[dev],
                               backend="program", batch_buckets=(2, 4),
                               batch_timeout_ms=2)
    rows.append(memory(torch, dev, "pool v1 built"))
    c.serve_clients(pool, feeds, 4)
    rows.append(memory(torch, dev, "after a load"))
    for i, d in enumerate((d2, d1, d2, d1)):
        stop, clients = threading.Event(), []
        if i == 0:
            def client(k):
                while not stop.is_set():
                    pool.predict(feeds[k % len(feeds)], timeout=600)
                    k += 4
            clients = [threading.Thread(target=client, args=(k,))
                       for k in range(4)]
            for t in clients:
                t.start()
        t0 = time.perf_counter()
        pool.swap_model(d)
        swap_s = time.perf_counter() - t0
        stop.set()
        for t in clients:
            t.join(timeout=600)
        rows.append(memory(torch, dev, "after swap %d to %s%s (%.2f s)" % (
            i + 1, os.path.basename(d), " under load" if i == 0 else "",
            swap_s), pool))
    pool.stop()
    del pool
    rows.append(memory(torch, dev, "pool stopped"))
    print(json.dumps(rows))


def main():
    import torch

    which = sys.argv[1:2] or ["phases"]
    if which[0] not in ("phases", "swap"):
        sys.exit("usage: pool_probe.py phases|swap")
    if not torch.cuda.is_available():
        sys.exit("pool_probe.py needs a CUDA device")
    from paddle_tpu_torch import cuda_kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c.log("card: %s | torch %s, CUDA %s" % (
        c.card_line(), torch.__version__, torch.version.cuda))
    cuda_kernels.load_library()
    {"phases": phases, "swap": swap}[which[0]](torch, dev)


if __name__ == "__main__":
    main()
