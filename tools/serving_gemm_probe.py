#!/usr/bin/env python3
"""Does a request's row keep its bits whatever batch it is served in?
(The check behind the serving backends' blocked ``mul``, ROADMAP F-6.)

    python3 tools/serving_gemm_probe.py        # needs a CUDA device

``ops.math_ops.blocked_matmul`` pads a product's rows to whole blocks of
``SERVING_BLOCK_ROWS`` rows, at least two, and runs them as one batched
product.  For
each serving product shape (K x N of Transformer-base scoring with 256
rows a sample: 512 x 512, 512 x 2048, 2048 x 512, 512 x 1536,
512 x 30000; of one-row samples: the MNIST MLP's 784 x 200, 200 x 200,
200 x 10 and ResNet-50's head 2048 x 1000), a batch of B samples is
multiplied at B in 1, 2, 3, 4, 8, 16, 17, 32 and 64 (one-row samples:
up to 1024, past the first block) and, for each B, at offsets 0 and 1
sample into the largest batch: every row is held against the same row
of the largest batch's product, bitwise (the max abs difference is
printed).  Beside it, one ``torch.mm`` over the same rows, which cuBLAS
is free to tile by the row count.  Then the host-timed ms of both at the
largest batch, and the relative error of a bf16 product against float64
with cuBLAS's reduced-precision bf16 reduction on and off.  float32,
TF32 off.
"""
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from paddle_tpu_torch.executor import SERVING_BLOCK_ROWS  # noqa: E402
from paddle_tpu_torch.ops.math_ops import blocked_matmul  # noqa: E402

SHAPES = ((256, ((512, 512), (512, 2048), (2048, 512), (512, 1536),
                 (512, 30000)), (1, 2, 3, 4, 8, 16, 17, 32, 64)),
          (1, ((784, 200), (200, 200), (200, 10), (2048, 1000)),
           (1, 2, 3, 4, 8, 16, 100, 255, 256, 257, 300, 1024)))


def ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def moved(fn, x, w, r, batches):
    """Per batch, the max abs difference of its rows from the largest
    batch's product at offsets 0 and 1 sample (0.0: bitwise)."""
    top = batches[-1]
    ref = fn(x[:(top + 1) * r], w)
    out = {}
    for b in batches:
        out[b] = max(float((fn(x[o * r:(o + b) * r], w)
                            - ref[o * r:(o + b) * r]).abs().max())
                     for o in (0, 1))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("serving_gemm_probe: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print(torch.__version__, torch.version.cuda, "block rows",
          SERVING_BLOCK_ROWS)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def blocked(x, w):
        return blocked_matmul(x, w, SERVING_BLOCK_ROWS)

    all_bitwise = True
    for r, shapes, batches in SHAPES:
        for K, N in shapes:
            x = torch.randn(((batches[-1] + 1) * r, K), generator=g,
                            device=dev)
            w = torch.randn((K, N), generator=g, device=dev)
            mb = moved(blocked, x, w, r, batches)
            mm = moved(torch.mm, x, w, r, batches)
            all_bitwise &= not any(mb.values())
            rows = batches[-1] * r
            tb = ms(lambda: blocked(x[:rows], w))
            tm = ms(lambda: torch.mm(x[:rows], w))
            print("rows/sample %d K %d N %d | blocked moved %s | mm moved %s"
                  " | ms at %d rows: blocked %.4f mm %.4f"
                  % (r, K, N, mb, mm, rows, tb, tm), flush=True)
            del x, w
            torch.cuda.empty_cache()
    print("blocked bitwise at every batch:", all_bitwise)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    for flag in (True, False):
        matmul.allow_bf16_reduced_precision_reduction = flag
        errs = []
        for M, K, N in ((16384, 512, 30000), (16384, 2048, 512)):
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            w = torch.randn((K, N), generator=g, device=dev).bfloat16()
            o = torch.mm(x, w).double()
            r = torch.mm(x.double(), w.double())
            errs.append(((o - r).abs().max() / r.abs().max()).item())
        print("bf16 reduced=%s rel err vocab %.3g ffn2 %.3g" % (flag, *errs))
    matmul.allow_bf16_reduced_precision_reduction = saved
    if not all_bitwise:
        raise SystemExit("serving_gemm_probe: a blocked row moved")


if __name__ == "__main__":
    main()
