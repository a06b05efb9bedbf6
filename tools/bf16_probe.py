#!/usr/bin/env python3
"""CPU probes that fix chip_smoke.py's bf16 limits before a chip run.

    python tools/bf16_probe.py resnet        # RESNET_BF16_FACTOR
    python tools/bf16_probe.py fold          # the bf16 fold's spread
    python tools/bf16_probe.py transformer   # BF16_LOSS_ULPS, BF16_GRAD_L2
    python tools/bf16_probe.py rehearse      # chip_smoke's bf16 phases

``resnet``: ResNet-50 (get_model(dtype="bfloat16")) at 64 x 64, 10
classes, batch 2, one momentum step from one bf16 state, three ways: the
port's CPU bf16 step at the default thread count and at 1 thread, and
(with ``--jax``) the JAX package's bf16 step; each held against the
port's float64 step from the same state widened (chip_smoke's
``resnet_errors``).  Prints each distance and its ratio to the first:
how far two bf16 steps that sum in other orders lie from each other's
distance to float64 (the card's step is such a step).

``fold``: chip_smoke's ``resnet_infer`` on the CPU at 64 x 64, batch 4,
bf16 state and images from a seeded startup: the folded and unfolded bf16
logits against each other and against the f32 Program's.

``transformer``: Transformer-base's layers at a small width
(``--layers``+``--layers`` layers, ``--d_model``, 8 heads, d_inner 4 x
d_model, vocab 500, batch 2 x 32, dropout 0) from bench.py's
bf16 state, one step through each package's ``program_to_fn`` (two bf16
implementations that sum in other orders, as the card and the CPU do):
chip_smoke's ``bf16_step_errors`` (the loss in bf16 ulps, all gradients'
L2 distance, each gradient's with flipped ReLU units left out); and the
port's float32 step from the same state against its bf16 step (the bf16
rounding's own size).

``rehearse``: chip_smoke's ResNet-50 bf16, Transformer bf16 and decorate
phases run on the CPU at small sizes (``torch.cuda``'s synchronisation
and memory calls stubbed, launch checks logged instead of raised, as the
plain versions count no launch): control flow, and the decorate leg's
losses against the f32 leg's.
"""
import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MEASURES = ("loss_rel", "fc_grad_worst_of_max", "grad_global_l2",
            "stat_worst_of_max")


def _small_resnet(c):
    c.RESNET_CFG = dict(class_dim=10, depth=50, image_shape=(3, 64, 64))


def resnet(args):
    import torch

    import chip_smoke as c
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet as R

    _small_resnet(c)
    cpu = torch.device("cpu")
    mbf, m64, state = c.resnet_bf16_state(torch, fluid, R, 5)
    x, y = c.resnet_images(np.random.RandomState(7), 2)
    x = torch.as_tensor(x).to(torch.bfloat16).float().numpy()
    ref = c.resnet_step(torch, fluid, m64, state, x, y, cpu)
    rows = {"port bf16, %d threads" % torch.get_num_threads():
            c.resnet_errors(c.resnet_step(torch, fluid, mbf, state, x, y,
                                          cpu), ref)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rows["port bf16, 1 thread"] = c.resnet_errors(
        c.resnet_step(torch, fluid, mbf, state, x, y, cpu), ref)
    torch.set_num_threads(threads)
    if args.jax:
        import ml_dtypes

        import paddle_tpu as jfluid
        from paddle_tpu.models import resnet as JR

        with jfluid.unique_name.guard():
            jm = JR.get_model(dtype="bfloat16", **c.RESNET_CFG)
        scope = jfluid.Scope()
        for n, v in state.items():
            a = v.float().numpy()
            scope[n] = a.astype(ml_dtypes.bfloat16) if (
                v.dtype == torch.bfloat16) else a
        grads = [p.name + "@GRAD" for p in
                 jm["main"].global_block().all_parameters() if p.trainable]
        stats = [p.name for p in jm["main"].global_block().all_parameters()
                 if not p.trainable]
        with jfluid.scope_guard(scope):
            out = jfluid.Executor(jfluid.CPUPlace()).run(
                jm["main"], feed={"data": x.astype(ml_dtypes.bfloat16),
                                  "label": y},
                fetch_list=[jm["loss"], jm["acc"]] + grads)
        step = {"loss": float(np.asarray(out[0]).astype(np.float64)[0]),
                "acc": float(np.asarray(out[1])[0]),
                "grads": {n: np.asarray(g).astype(np.float64)
                          for n, g in zip(grads, out[2:])},
                "stats": {n: np.asarray(scope[n]).astype(np.float64)
                          for n in stats}}
        rows["jax bf16"] = c.resnet_errors(step, ref)
    first = next(iter(rows.values()))
    for name, e in rows.items():
        print("%-24s %s" % (name, "  ".join(
            "%s %.4g (x%.3f)" % (k, e[k], e[k] / max(first[k], 1e-30))
            for k in MEASURES)))


def fold(args):
    import torch

    import chip_smoke as c
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet as R

    _small_resnet(c)
    cpu = torch.device("cpu")
    m = c.resnet_model(fluid, R, "bfloat16")
    m["startup"].random_seed = 5
    scope = fluid.Scope()
    fluid.Executor(device=cpu).run(m["startup"], scope=scope)
    c.log = lambda *a: None
    out = c.resnet_infer(torch, fluid, R, cpu, m, scope, 4,
                         c.resnet_model(fluid, R)["test"])
    print("folded vs unfolded bf16: %.4g of the logits' max %.4g"
          % (out["folded_vs_unfolded_of_max"], out["logits_max_abs"]))
    print("against the f32 Program: %s" % out["against_f32"])


def transformer(args):
    import ml_dtypes
    import torch

    import paddle_tpu as jfluid
    import paddle_tpu_torch as fluid
    from paddle_tpu.jax_bridge import init_state
    from paddle_tpu.jax_bridge import program_to_fn as jax_fn
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch.models import transformer as TT
    from paddle_tpu_torch.program_fn import program_to_fn

    cfg = dict(batch_size=2, seq_len=32, src_vocab_size=500,
               trg_vocab_size=500, max_length=32, n_layer=args.layers,
               n_head=8, d_model=args.d_model, d_inner=4 * args.d_model,
               dropout=0.0, use_flash=True)
    with jfluid.unique_name.guard():
        jm = JT.get_model(**cfg)
    with fluid.unique_name.guard():
        tm = TT.get_model(**cfg)
    state = {k: np.asarray(v) for k, v in init_state(jm["startup"]).items()}
    bf = {k: (v.astype(ml_dtypes.bfloat16) if v.dtype == np.float32 else v)
          for k, v in state.items()}
    import chip_smoke as c

    feed = c.make_feeds(np.random.RandomState(3), 2, 32, 500)
    grads = [p.name + "@GRAD" for p in
             tm["main"].global_block().all_parameters() if p.trainable]
    gates = c.relu_gates(tm["main"])
    fetch = [tm["loss"].name] + grads + [pre for pre, _, _ in gates]
    want = [np.asarray(a).astype(np.float64)
            for a in jax_fn(jm["main"], fetch)(bf, feed)]
    port = program_to_fn(tm["main"], fetch, device="cpu")
    got = [t.double().numpy() for t in port(bf, feed)]
    wide = {k: (v.astype(np.float32) if v.dtype == ml_dtypes.bfloat16
                else v) for k, v in bf.items()}
    f32 = [t.double().numpy() for t in port(wide, feed)]
    errs = {}
    for name, a, b in (("port bf16 vs jax bf16", got, want),
                       ("port bf16 vs port f32", got, f32),
                       ("jax bf16 vs port f32", want, f32)):
        e = errs[name] = c.bf16_step_errors(grads, gates, a, b)
        print("%-24s loss %.2f bf16 ulps; gradients: all %.4g (L2), each "
              "median %.4g, worst %.4g (%s); %d gate flips, %d units left "
              "out" % (name, e["loss_ulps"], e["grad_global_l2"],
                       e["grad_l2_median"], e["grad_l2_worst"],
                       e["grad_l2_worst_name"], e["relu_gate_flips"],
                       e["units_left_out"]))
    ratios = c.bf16_noise_ratios(errs["port bf16 vs jax bf16"],
                                 errs["port bf16 vs port f32"])
    worst = max(ratios, key=ratios.get)
    print("each gradient's port-vs-jax distance over the port's bf16 noise "
          "(floor %g): median %.3f, 90th %.3f, worst %.3f (%s)"
          % (c.BF16_NOISE_FLOOR, np.median(list(ratios.values())),
             np.percentile(list(ratios.values()), 90), ratios[worst],
             worst))


def rehearse(args):
    import torch

    import chip_smoke as c
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import flash_attention as fa

    failed = []

    def check(ok, *what):
        if not ok:
            failed.append(what)

    c.check = check
    for n in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, n, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    fa._sm_count = lambda index: 132
    fluid.CUDAPlace = lambda *a: fluid.CPUPlace()
    _small_resnet(c)
    c.RESNET_BATCH, c.RESNET_STEPS, c.RESNET_INFER_BATCH = 4, 3, 4
    c.TRAIN_CFG = dict(batch_size=2, seq_len=32, src_vocab_size=100,
                       trg_vocab_size=100, max_length=32, use_flash=True,
                       n_layer=1, n_head=8, d_model=64, d_inner=128)
    c.CHECK_CFG = dict(c.TRAIN_CFG, dropout=0.0)
    c.TRAIN_STEPS, c.DECORATE_STEPS = 3, 3
    dev = torch.device("cpu")
    f32 = {"train": {"images_per_s": 0.0, "share_of_bound": 0.0,
                     "peak_memory_gib": 0.0, "step_ms": 0.0},
           "infer": {"images_per_s_unfolded": 0.0,
                     "images_per_s_folded": 0.0}}
    c.resnet_bf16_phase(torch, fluid, fa, dev, f32)
    trn = c.train_phase(torch, fluid, T, fa, dev, c.TRAIN_CFG,
                        c.TRAIN_STEPS, "auto", "rehearsal")
    c.transformer_bf16_phase(torch, fluid, T, fa, dev, trn)
    dec = c.transformer_decorate_phase(torch, fluid, T, fa, dev, trn)
    print("decorate losses against the f32 leg's, relative: %s"
          % dec["loss_rel_to_f32"])
    print("checks that failed (launch counts cannot move on the CPU): %d"
          % len(failed))
    for what in failed:
        print("  ", str(what)[:200])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("resnet")
    r.add_argument("--jax", action="store_true",
                   help="also the JAX package's bf16 step")
    sub.add_parser("fold")
    t = sub.add_parser("transformer")
    t.add_argument("--layers", type=int, default=6)
    t.add_argument("--d_model", type=int, default=128)
    sub.add_parser("rehearse")
    args = ap.parse_args()
    globals()[args.cmd](args)


if __name__ == "__main__":
    main()
