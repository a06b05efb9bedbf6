#!/usr/bin/env python3
"""The Trainer and reader runtime on one CUDA device, piece by piece.

    python3 tools/trainer_probe.py phases lenet fast trainer lenet_trainer
    python3 tools/trainer_probe.py determinism
    python3 tools/trainer_probe.py prefetch

``phases`` runs chip_smoke.py's phase functions named on the command
line, in order, after building the kernels: ``lenet`` (lenet_phase),
``fast`` (fast_path_phase), ``trainer`` (trainer_phase, which reads the
graphed step ms of ``fast`` when it ran first) and ``lenet_trainer``
(lenet_trainer_phase, which reads ``lenet``'s images/s).  A failed phase
is printed and the others still run; the exit code is 1 if any failed.

``determinism`` trains MNIST LeNet at batch 128 through ``fluid.Trainer``
for 10 steps, twice with prefetch and twice without, first with cuDNN's
default algorithms and then with ``torch.backends.cudnn.deterministic``,
and prints, for each run, the first step whose loss differs in bits from
the first run without prefetch.

``prefetch`` times the pieces of the device prefetch pipeline on LeNet's
batches (128 synthetic MNIST samples a batch): DataFeeder's host
conversion, the feeder's synchronous conversion to the card, the
pipeline's transfer (a pinned copy and a ``non_blocking`` copy on a
side stream) with and without the hand-off to the current stream, a
pinned allocation and copy alone, and the whole pipeline iterated with
no step behind it, at three of Python's thread switch intervals.  Times
are host ms a batch (each loop ends with a device sync).

f32 with TF32 off.  Needs the repository (it imports chip_smoke.py).
"""
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import executor as executor_mod  # noqa: E402
from paddle_tpu_torch.models import mnist  # noqa: E402
from paddle_tpu_torch.parallel import flash_attention as fa  # noqa: E402


def phases(names):
    from paddle_tpu_torch import cuda_kernels, observability as obs
    from paddle_tpu_torch.models import transformer as T

    t = time.perf_counter()
    cuda_kernels.load_library()
    print("build %.1f s" % (time.perf_counter() - t), flush=True)
    dev = torch.device("cuda", 0)
    lenet = {"images_per_s": None}
    fast = {"graphed_step_ms": None}
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            if name == "lenet":
                lenet = c.lenet_phase(torch, fluid, dev)
            elif name == "fast":
                fast = c.fast_path_phase(torch, fluid, T, fa, dev)
            elif name == "trainer":
                if fast["graphed_step_ms"] is None:
                    fast["graphed_step_ms"] = float("nan")
                c.trainer_phase(torch, fluid, T, fa, obs, dev, fast)
            elif name == "lenet_trainer":
                c.lenet_trainer_phase(torch, fluid, fa, dev, lenet)
            else:
                raise ValueError("unknown phase %r" % name)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        torch.cuda.empty_cache()
        print("phase %s %.1f s" % (name, time.perf_counter() - t0), flush=True)
    print("failed: %s" % failed, flush=True)
    return 1 if failed else 0


def _lenet_trainer():
    tf, of, _ = c.lenet_trainer_funcs(fluid, mnist, {})
    return tf, of


def determinism():
    tf, of = _lenet_trainer()
    samples = c.synthetic_mnist(c.LENET_BATCH * 10, c.SEED + 70)
    reader = fluid.reader.batch(lambda: iter(samples), c.LENET_BATCH)

    def run(prefetch, deterministic):
        torch.backends.cudnn.deterministic = deterministic
        try:
            np.random.seed(c.SEED + 71)
            t = fluid.Trainer(tf, of, place=fluid.CUDAPlace(0))
            r = c.trainer_run(fluid, fa, executor_mod, t, reader,
                              ["pixel", "label"], 9, prefetch=prefetch)
        finally:
            torch.backends.cudnn.deterministic = False
        return [x.tobytes() for x in r["losses"]], r["losses"]

    for det in (False, True):
        runs = {(p, k): run(p, det) for p in (False, True) for k in (0, 1)}
        base = runs[(False, 0)][0]
        print("cudnn.deterministic=%s" % det, flush=True)
        for (prefetch, k), (bits, losses) in runs.items():
            first = next((i for i, (a, b) in enumerate(zip(bits, base))
                          if a != b), None)
            print("  prefetch=%s run %d: first step differing from the "
                  "first run without prefetch: %s; losses %s"
                  % (prefetch, k, first,
                     [float(np.ravel(x)[0]) for x in losses[:4]]),
                  flush=True)
    return 0


def prefetch():
    from paddle_tpu_torch.reader import device_prefetch as dp

    tf, of = _lenet_trainer()
    t = fluid.Trainer(tf, of, place=fluid.CUDAPlace(0))
    prog = t.train_program
    feeder = fluid.DataFeeder(
        [prog.global_block().var(n) for n in ("pixel", "label")],
        fluid.CUDAPlace(0), program=prog)
    samples = c.synthetic_mnist(c.LENET_BATCH * 50, 1)
    batches = [samples[i * c.LENET_BATCH:(i + 1) * c.LENET_BATCH]
               for i in range(50)]
    dev = t.exe.device
    stream = torch.cuda.Stream(dev)
    hosts = [feeder._feed_host(b) for b in batches]
    x = torch.as_tensor(hosts[0]["pixel"])

    def per_call(fn, n=50):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def pipeline():
        gen = dp.decorate_device_feed(
            fluid.reader.batch(lambda: iter(samples), c.LENET_BATCH),
            feeder, t.exe, prog)()
        next(gen)
        t0 = time.perf_counter()
        k = 0
        for _ in gen:
            k += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k * 1e3

    rows = [
        ("DataFeeder host conversion", lambda i: feeder._feed_host(batches[i])),
        ("DataFeeder.feed to the card", lambda i: feeder.feed(batches[i])),
        ("transfer", lambda i: dp._place_feed(hosts[i], dev, prog, stream)),
        ("transfer and hand-off", lambda i: dp._place_feed(
            hosts[i], dev, prog, stream).handoff()),
        ("pinned allocation and copy", lambda i: torch.empty(
            x.shape, dtype=x.dtype, pin_memory=True).copy_(x)),
    ]
    for label, fn in rows:
        print("%s: %.3f ms a batch" % (label, per_call(fn)), flush=True)
    saved = sys.getswitchinterval()
    try:
        for si in (0.005, 0.001, 0.0002):
            sys.setswitchinterval(si)
            print("pipeline alone, switch interval %g s: %.3f ms a batch"
                  % (si, pipeline()), flush=True)
    finally:
        sys.setswitchinterval(saved)
    return 0


def main():
    if not torch.cuda.is_available():
        print("trainer_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(c.card_line(), torch.__version__, torch.version.cuda, flush=True)
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "phases":
        return phases(sys.argv[2:])
    if what == "determinism":
        return determinism()
    if what == "prefetch":
        return prefetch()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
