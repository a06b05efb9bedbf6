#!/usr/bin/env python3
"""The flash forward kernel (B1) against the two versions it was chosen
over, on one NVIDIA GPU:

    python3 tools/flash_fwd_variants.py

- ``first``: the first register-tiled version: blocks without a causal
  mask launched in grid order, the online softmax by ``expf`` with a
  per-pair ``visible()`` mask on partial tiles;
- ``order``: ``first`` with the tree's launch order (without a causal
  mask, the blocks of the longest sequences first);
- ``tree``: the kernel in ``paddle_tpu_torch/csrc/flash_attention.cu``
  (``order`` plus the softmax in log2 units by ``exp2f`` and one key
  limit a row).

The two older versions are made from the tree's source by undoing those
changes as text (each edit must match exactly once, so the script fails
loudly once the kernel moves on) and built into the gitignored
``build/flash_fwd_variants/``.  Each is held against the plain version at
chip_smoke.py's sweep shapes (float32 and bfloat16, the training feeds'
kv_lens), ``order`` against ``first`` bitwise (a launch-order change);
then all three are timed from torch.profiler windows in turns (first,
order, tree, tree, order, first) at three sweep shapes, beside SDPA's
forward and the bound.  Needs the repository and a CUDA device.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "build", "flash_fwd_variants")
TIMED = ((64, 8, 256, 64), (4, 8, 4096, 64), (16, 8, 1024, 64))

# tree -> order: the softmax back to expf and the per-pair mask
TO_ORDER = (
    ("""  const float scale2 = scale * 1.4426950408889634f;  // scores in log2 units
""", ""),
    ("""      // keys [k0, lim) of this row are visible (all of the tile if `all`)
      int lim = row < Tq ? (causal ? min(kvl, row + shift + 1) : kvl) : 0;
      lim = all ? k0 + kTile : lim;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[i][j] = k0 + ln.c8 + 8 * j < lim ? x[i][j] * scale2 : kNegInf;
        mx = fmaxf(mx, x[i][j]);
      }
      const float m_new = fmaxf(m[i], oct_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[i][j] = k0 + ln.c8 + 8 * j < lim ? exp2f(x[i][j] - m_new) : 0.f;
        psum += x[i][j];
      }""", """      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok =
            all || visible(row, k0 + ln.c8 + 8 * j, Tq, kvl, causal, shift);
        x[i][j] = ok ? x[i][j] * scale : kNegInf;
        mx = fmaxf(mx, x[i][j]);
      }
      const float m_new = fmaxf(m[i], oct_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok =
            all || visible(row, k0 + ln.c8 + 8 * j, Tq, kvl, causal, shift);
        x[i][j] = ok ? expf(x[i][j] - m_new) : 0.f;
        psum += x[i][j];
      }"""),
    ("""(m[i] == kNegInf ? kNegInf : m[i] * 0.6931471805599453f) +""",
     """m[i] +"""),
)
# order -> first: every block in grid order
TO_FIRST = (
    ("""  } else {  // the longest sequences first
    const int B = gridDim.x / H;
    const int per_b = H * gridDim.y;
    const int L = blockIdx.x + gridDim.x * blockIdx.y;
    const int r = L / per_b;
    h = (L - r * per_b) / gridDim.y;
    q0 = (L - r * per_b - h * gridDim.y) * kF1Rows;
    b = kv_lens && B <= kF1RankMax
            ? b_by_length(kv_lens, B, S, r, reinterpret_cast<int*>(PT))
            : r;
  }""", """  } else {
    b = blockIdx.x / H;
    h = blockIdx.x - b * H;
    q0 = (gridDim.y - 1 - blockIdx.y) * kF1Rows;
  }"""),
)


def patched(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError("the kernel source moved on: an edit of this "
                               "script no longer matches it exactly once:\n"
                               + old[:300])
        text = text.replace(old, new)
    return text


def build_variants(ck):
    """{name: ctypes library} of the two older versions, built in
    parallel from the tree's source."""
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    tree = open(os.path.join(csrc, "flash_attention.cu")).read()
    order = patched(tree, TO_ORDER)
    sources = {"order": order, "first": patched(order, TO_FIRST)}
    procs = {}
    for name, text in sources.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "flash_attention.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [ck.nvcc_path(), *ck.NVCC_FLAGS, "-I", csrc, "-shared", src,
             "-o", os.path.join(d, "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, err[-4000:]))
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        for fn, argtypes in ck._SIGNATURES:
            if fn.startswith("pt_flash"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_fwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from paddle_tpu_torch import cuda_kernels as ck
    from paddle_tpu_torch.parallel import flash_attention as fa

    dev = torch.device("cuda", 0)
    print("card:", c.card_line(), flush=True)
    libs = build_variants(ck)
    libs["tree"] = ck.load_library()
    gen = torch.Generator(device=dev).manual_seed(c.SEED + 20)
    rng = np.random.RandomState(c.SEED + 20)

    def run(name, *args):
        ck._lib = libs[name]
        return fa._flash_fwd_cuda(*args)

    for shape in c.SWEEP_SHAPES:
        B, H, T, D = shape
        for causal in (False, True):
            for dtype in ("float32", "bfloat16"):
                q, k, v, _ = c.flash_inputs(torch, dev, gen,
                                            getattr(torch, dtype), T, T, B,
                                            H, D)
                lens = torch.as_tensor(
                    c.flash_lens(rng, T, with_zeros=False, B=B), device=dev)
                args = (q, k, v, lens, causal, D ** -0.5)
                ref = fa._flash_fwd_reference(q.float(), k.float(),
                                              v.float(), *args[3:])
                outs = {n: run(n, *args) for n in ("first", "order", "tree")}
                torch.cuda.synchronize()
                errs = {n: max(c.flash_err(a, r, dtype)
                               for a, r in zip(o, ref))
                        for n, o in outs.items()}
                c.check(max(errs.values()) <= c.FLASH_TOL[dtype][0],
                        "variant vs plain", shape, causal, dtype, errs)
                c.check(all(torch.equal(a, b) for a, b in
                            zip(outs["order"], outs["first"])),
                        "launch order changed the bits", shape, causal)
                print("check %s %-6s %-8s err vs plain %s; order == first "
                      "bitwise" % (list(shape), "causal" if causal else
                                   "full", dtype,
                                   {n: "%.3g" % e for n, e in errs.items()}),
                      flush=True)
        torch.cuda.empty_cache()

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    for shape in TIMED:
        B, H, T, D = shape
        for causal in (False, True):
            q, k, v, _ = c.flash_inputs(torch, dev, gen, torch.float32, T, T,
                                        B, H, D)
            lens_np = c.flash_lens(rng, T, with_zeros=False, B=B)
            lens = torch.as_tensor(lens_np, device=dev)
            args = (q, k, v, lens, causal, D ** -0.5)
            iters = 20 if T <= 512 else 10
            ms = {}
            for name in ("first", "order", "tree", "tree", "order", "first"):
                t, _ = c.kernel_ms(torch, lambda: run(name, *args), iters,
                                   flush, ("flash_fwd_kernel",))
                ms.setdefault(name, []).append(t["flash_fwd_kernel"])
            mask = (torch.arange(T, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            if causal:
                mask = mask & torch.ones((T, T), dtype=torch.bool,
                                         device=dev).tril()
            sdpa = c.time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), iters, flush)
            bound = c.flash_bounds(lens_np, T, T, causal, 4, H, D)[0]
            print("time %s %-6s f32 kv_lens mean %.1f: device ms %s | sdpa "
                  "fwd %.4f ms | bound %.4f ms (%s)"
                  % (list(shape), "causal" if causal else "full",
                     lens_np.mean(), {n: [round(x, 4) for x in t]
                                      for n, t in ms.items()},
                     sdpa, *bound), flush=True)
            del q, k, v
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
