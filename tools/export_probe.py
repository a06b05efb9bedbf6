#!/usr/bin/env python3
"""Recompute and the metrics export plane on one CUDA device.

    python3 tools/export_probe.py recompute decode 3 predict 5

Runs its commands in order, after building the kernels:

``recompute`` runs chip_smoke.py's recompute_phase (Transformer-base at
4 x 4096, 4 steps without and with ``enable_recompute(4)``).

``decode N`` runs chip_smoke.py's serving_phase N times in one process:
each serves the 16 requests first on an engine without an endpoint and
then on one whose ``/metrics`` is scraped every SCRAPE_EVERY_S, and
prints both tokens/s.

``predict N`` serves predict's load (64 requests of 1-4 rows from 8
clients, Transformer-base scoring saved without the export artifact) on
a fresh Program-backend engine per run, N rounds of three modes in
rotated order: no endpoint, the endpoint open and not scraped, the
endpoint scraped every SCRAPE_EVERY_S.  It prints each run's
requests/s, p50 latency and scrape count, whether its logits are
bitwise the first run's, and each mode's median.

f32 with TF32 off.  Needs the repository (it imports chip_smoke.py).
"""
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import cuda_kernels  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch import serving  # noqa: E402
from paddle_tpu_torch.models import transformer as T  # noqa: E402
from paddle_tpu_torch.parallel import flash_attention as fa  # noqa: E402


def decode(dev, n):
    for i in range(n):
        st, _, _ = c.serving_phase(torch, T, serving, fa, obs, dev)
        print("decode run %d: %.1f tokens/s scraped, %.1f without an "
              "endpoint (run first)" % (
                  i, st["tokens_per_s"],
                  st["export"]["tokens_per_s_without_endpoint"]), flush=True)
        torch.cuda.empty_cache()


def predict(dev, rounds):
    tmp = tempfile.mkdtemp(prefix="export_probe_")
    try:
        d = os.path.join(tmp, "v1")
        c.save_predict_model(fluid, T, d, c.SEED + 50, aot=False)
        vocab, seq = c.TRAIN_CFG["trg_vocab_size"], c.TRAIN_CFG["seq_len"]
        rng = np.random.RandomState(c.SEED + 52)
        sizes = rng.randint(1, 5, size=c.PREDICT_REQUESTS)
        feeds = [c.predict_feed(*c.predict_rows(rng, int(k), seq, vocab))
                 for k in sizes]
        modes = ("none", "open", "scraped")
        res = {m: [] for m in modes}
        ref = None
        for r in range(rounds):
            for mode in modes[r % 3:] + modes[:r % 3]:
                eng = c.predict_engine(serving, d, dev, backend="program",
                                       batch_timeout_ms=2)
                scraper = None
                if mode != "none":
                    srv = eng.serve_metrics(host="127.0.0.1")
                    if mode == "scraped":
                        scraper = c.Scraper(obs, srv)
                outs, lat, wall = c.serve_clients(eng, feeds, 8)
                scrapes = scraper.stop() if scraper else 0
                eng.stop()
                ref = outs if ref is None else ref
                same = all(a.tobytes() == b.tobytes()
                           for a, b in zip(outs, ref))
                res[mode].append(c.PREDICT_REQUESTS / wall)
                print("round %d %s: %.2f requests/s, p50 %.1f ms, scrapes "
                      "%d, bitwise %s" % (
                          r, mode, c.PREDICT_REQUESTS / wall,
                          np.percentile(lat, 50) * 1e3, scrapes, same),
                      flush=True)
                del eng
                torch.cuda.empty_cache()
        print(json.dumps({m: {"runs": v, "median": float(np.median(v))}
                          for m, v in res.items()}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv):
    print(c.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_kernels.load_library()
    dev = torch.device("cuda", 0)
    args = list(argv)
    while args:
        cmd = args.pop(0)
        t0 = time.perf_counter()
        if cmd == "recompute":
            c.recompute_phase(torch, fluid, T, fa, dev)
        elif cmd in ("decode", "predict"):
            n = int(args.pop(0))
            (decode if cmd == "decode" else predict)(dev, n)
        else:
            raise SystemExit("unknown command %r" % cmd)
        torch.cuda.empty_cache()
        print("%s %.1f s" % (cmd, time.perf_counter() - t0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
