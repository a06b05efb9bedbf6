#!/usr/bin/env python3
"""The paged decode kernel (B4) at the split sizes, tile heights and ring
sizes it was chosen from, and beside an earlier tree's B4, on one NVIDIA GPU:

    python3 tools/paged_decode_variants.py [--parent DIR]

- ``tree``: the kernel in ``paddle_tpu_torch/csrc/paged_attention.cu``;
- ``keysN``: the tree with splits of at most N keys (``kSplitKeys``);
- ``tile64``: the tree with 64-key staged tiles (``kDT``);
- ``ringN``: the tree with an N-KiB ring of staged tiles (``kRingBytes``);
- ``parent`` (with ``--parent DIR``, an unpacked checkout of an earlier
  commit whose ``pt_paged_decode`` takes no workspace: one block per
  (slot, head), as before the split design): that tree's B4.

The variants are made from the tree's source by editing one constant as
text (each edit must match exactly once, so the script fails loudly once
the kernel moves on) and built in parallel into the gitignored
``build/paged_decode_variants/``, with their ``-Xptxas -v`` register and
spill lines printed.  Each variant is held against the plain version at
every row below (float32 and bfloat16, within chip_smoke's KERNEL_TOL)
and a slot alone against the batched call, bitwise; then all are timed in
turns (the list, then the list reversed) at chip_smoke.py's B4 sweep rows
and at every slot full with its pages in pool order: device time from a
torch.profiler window (split + merge) and CUDA events (chip_smoke's
``timed``), the L2 flushed before each call, beside the bound.  Needs the
repository and a CUDA device.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "build", "paged_decode_variants")
SPLIT_LINE = "constexpr int kSplitKeys = 256;"
TILE_LINE = "constexpr int kDT = 32;"
RING_LINE = "constexpr int kRingBytes = 64 * 1024;"
# name: (split keys, text edit)
VARIANTS = {
    "keys128": (128, (SPLIT_LINE, "constexpr int kSplitKeys = 128;")),
    "keys512": (512, (SPLIT_LINE, "constexpr int kSplitKeys = 512;")),
    "tile64": (256, (TILE_LINE, "constexpr int kDT = 64;")),
    "ring32": (256, (RING_LINE, "constexpr int kRingBytes = 32 * 1024;")),
    "ring96": (256, (RING_LINE, "constexpr int kRingBytes = 96 * 1024;")),
}
# the parent's C entry: no workspace (one block per (slot, head))
PARENT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def patched(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError("the kernel source moved on: an edit of this "
                           "script no longer matches it exactly once: " + old)
    return text.replace(old, new)


def build(ck, sources, csrc_of):
    """{name: (ctypes library, ptxas log)} of each source text, built in
    parallel."""
    procs = {}
    for name, text in sources.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "paged_attention.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [ck.nvcc_path(), *ck.NVCC_FLAGS, "-I", csrc_of[name], "-shared",
             src, "-o", os.path.join(d, "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, err[-4000:]))
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        fn = lib.pt_paged_decode
        fn.argtypes = PARENT_ARGTYPES if name == "parent" else dict(
            ck._SIGNATURES)["pt_paged_decode"]
        fn.restype = ctypes.c_int
        out[name] = (lib, err)
    return out


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of an earlier "
                    "commit, whose B4 is timed beside the tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_decode_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from paddle_tpu_torch import cuda_kernels as ck
    from paddle_tpu_torch.parallel import flash_attention as fa

    dev = torch.device("cuda", 0)
    print("card:", c.card_line(), flush=True)
    csrc = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    tree = open(os.path.join(csrc, "paged_attention.cu")).read()
    sources = {name: patched(tree, *edit)
               for name, (_, edit) in VARIANTS.items()}
    csrc_of = dict.fromkeys(sources, csrc)
    if args.parent:
        pcsrc = os.path.join(os.path.abspath(args.parent), "paddle_tpu_torch",
                             "csrc")
        sources["parent"] = open(os.path.join(pcsrc,
                                              "paged_attention.cu")).read()
        csrc_of["parent"] = pcsrc
    built = build(ck, sources, csrc_of)
    ck.load_library()
    built["tree"] = (ck._lib, ck.build_info()["log"])
    keys = dict({n: k for n, (k, _) in VARIANTS.items()},
                tree=fa._B4_SPLIT_KEYS)
    for name, (_, log) in built.items():
        for kernel, regs, spill in c.ptxas_report(log):
            if kernel.startswith("paged_decode"):
                print("ptxas %-8s %s: %d registers, %d bytes spilled"
                      % (name, kernel, regs, spill), flush=True)

    def caller(name, q, k, v, tables, lens):
        """A call of variant ``name`` through the wrapper (the parent's
        entry directly, with its own signature)."""
        if name == "parent":
            lib = built["parent"][0]
            S_, H_, D_ = q.shape

            def call():
                out = torch.empty_like(q)
                err = lib.pt_paged_decode(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    tables.data_ptr(), lens.data_ptr(), out.data_ptr(), S_,
                    H_, D_, k.shape[1], tables.shape[1], D_ ** -0.5,
                    int(k.dtype == torch.bfloat16), 0,
                    torch.cuda.current_stream().cuda_stream)
                c.check(err == 0, "parent launch", err)
                return out
            return call

        def call():
            ck._lib = built[name][0]
            fa._B4_SPLIT_KEYS = keys[name]
            return fa.paged_decode_attention(q, k, v, tables, lens)
        return call

    gen = torch.Generator(device=dev).manual_seed(c.SEED + 30)
    rng = np.random.RandomState(c.SEED + 30)
    served = rng.randint(32, c.NEW_TOKENS + 1501, size=c.S).astype(np.int32)
    solo = np.zeros(c.S, np.int32)
    solo[0] = 2047
    # (label, kv_lens, dtype, heads, head_dim, pages in order): "seq" has
    # each slot's pages consecutive in the pool, the others a random
    # placement, as chip_smoke's rows
    rows = (("table", c.DECODE_LENS, "float32", c.H, c.DH, False),
            ("table", c.DECODE_LENS, "bfloat16", c.H, c.DH, False),
            ("full", np.full(c.S, 2048, np.int32), "float32", c.H, c.DH,
             False),
            ("full-seq", np.full(c.S, 2048, np.int32), "float32", c.H, c.DH,
             True),
            ("served", served, "float32", c.H, c.DH, False),
            ("solo", solo, "float32", c.H, c.DH, False),
            ("dh128", c.DECODE_LENS, "float32", 4, 128, False))
    names = list(built)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    for label, lens_np, dtype, heads, dh, in_order in rows:
        k = torch.randn((c.NUM_PAGES, c.PS, heads, dh), generator=gen,
                        device=dev).to(getattr(torch, dtype))
        v = torch.randn((c.NUM_PAGES, c.PS, heads, dh), generator=gen,
                        device=dev).to(getattr(torch, dtype))
        order = (torch.arange(c.NUM_PAGES - 1, device=dev) if in_order else
                 torch.randperm(c.NUM_PAGES - 1, generator=gen, device=dev))
        tables = order[:c.S * c.MP].reshape(c.S, c.MP).add(1).int()
        lens = torch.as_tensor(lens_np, device=dev)
        q = torch.randn((c.S, heads, dh), generator=gen, device=dev)
        ref = fa._paged_reference(q, k, v, tables, lens, dh ** -0.5)
        calls = {n: caller(n, q, k, v, tables, lens) for n in names}
        errs = {}
        for n in names:
            out = calls[n]()
            torch.cuda.synchronize()
            errs[n] = (out - ref).abs().max().item()
            if n != "parent":
                one = caller(n, q[6:7], k, v, tables[6:7], lens[6:7])()
                c.check(torch.equal(one, out[6:7]), "alone != batched", n,
                        label)
        c.check(max(errs.values()) <= c.KERNEL_TOL, "variant vs plain",
                label, dtype, errs)
        dev_ms, ev_ms = {}, {}
        for n in names + names[::-1]:
            kernels = c.B4_KERNELS[:1] if n == "parent" else c.B4_KERNELS
            apart, _ = c.kernel_ms(torch, calls[n], 20, flush, kernels)
            dev_ms.setdefault(n, []).append(sum(apart.values()))
            ev_ms.setdefault(n, []).append(c.time_ms(calls[n], 30, flush))
        nbytes, flops = c.decode_bytes_flops(lens_np, heads, dh,
                                             k.element_size())
        bound = c.bound_ms(nbytes, flops)
        print("time %-8s %-8s H=%d Dh=%d kv_lens=%s: device ms (profiler, "
              "two turns) %s | CUDA events %s | bound %.4f ms (%s) | err vs "
              "plain %s (tol %g)"
              % (label, dtype, heads, dh, lens_np.tolist(),
                 {n: [round(x, 4) for x in t] for n, t in dev_ms.items()},
                 {n: [round(x, 4) for x in t] for n, t in ev_ms.items()},
                 bound[0], bound[1], {n: "%.3g" % e for n, e in errs.items()},
                 c.KERNEL_TOL), flush=True)
        del k, v
        torch.cuda.empty_cache()
    ck._lib = built["tree"][0]
    fa._B4_SPLIT_KEYS = keys["tree"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
