#!/usr/bin/env python3
"""CPU probes of ResNet-50's training numerics, for either package.

    python tools/resnet_probe.py trajectory --package port --batch 16
    python tools/resnet_probe.py trajectory --package jax --batch 16
    python tools/resnet_probe.py gate-flips

``trajectory``: ``models.resnet.get_model()`` (depth 50, 224 x 224, 1000
classes, momentum 0.9 at lr 0.1) from a seeded startup, trained on one
seeded batch of normal images for ``--steps`` steps; prints each step's
loss and accuracy.  At lr 0.1 the loss falls for a step or two, then
climbs for several before it falls again, in both packages.

``gate-flips``: the port in float64 at 64 x 64, batch 4, 10 classes: one
step's gradient from one set of weights with the images moved by 0,
1e-12 and 1e-7 relative; prints the L2 change of all gradients and the
ReLU gates that flipped.  The gradient moves by rounding alone until a
gate flips, then by whole percents (tests/test_torch_resnet.py).
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def trajectory(args):
    if args.package == "jax":
        import paddle_tpu as fluid
        from paddle_tpu.models import resnet
    else:
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import resnet
    with fluid.unique_name.guard():
        m = resnet.get_model(class_dim=1000, depth=50,
                             image_shape=(3, args.size, args.size))
    m["startup"].random_seed = 62
    rng = np.random.RandomState(63)
    x = rng.randn(args.batch, 3, args.size, args.size).astype("float32")
    y = rng.randint(0, 1000, (args.batch, 1)).astype("int64")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(m["startup"])
        for step in range(args.steps):
            t0 = time.perf_counter()
            loss, acc = exe.run(m["main"], feed={"data": x, "label": y},
                                fetch_list=[m["loss"], m["acc"]])
            print("step %d loss %.4f accuracy %.4f (%.1f s)"
                  % (step + 1, float(np.asarray(loss).ravel()[0]),
                     float(np.asarray(acc).ravel()[0]),
                     time.perf_counter() - t0), flush=True)


def gate_flips(args):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet

    with fluid.unique_name.guard():
        m = resnet.get_model(class_dim=10, depth=50, image_shape=(3, 64, 64),
                             dtype="float64")
    m["startup"].random_seed = 5
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(m["startup"], scope=scope)
    state = {n: scope[n].numpy() for n in m["main"].persistable_names()
             if n in scope}
    blk = m["main"].global_block()
    grads = [p.name + "@GRAD" for p in blk.all_parameters() if p.trainable]
    gates = [op.inputs["X"][0] for op in blk.ops if op.type == "relu"]
    rng = np.random.RandomState(7)
    x = rng.rand(4, 3, 64, 64)
    label = rng.randint(0, 10, (4, 1)).astype("int64")
    noise = rng.randn(*x.shape)
    outs = []
    for eps in (0.0, 1e-12, 1e-7):
        scope = fluid.Scope()
        fluid.load_numpy_state(m["main"], state, scope=scope, device="cpu")
        outs.append(exe.run(m["main"], scope=scope,
                            feed={"data": x * (1 + eps * noise),
                                  "label": label},
                            fetch_list=grads + gates))
    g0 = np.concatenate([a.ravel() for a in outs[0][:len(grads)]])
    for eps, out in zip((1e-12, 1e-7), outs[1:]):
        g = np.concatenate([a.ravel() for a in out[:len(grads)]])
        flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in
                    zip(outs[0][len(grads):], out[len(grads):]))
        print("images moved by %g: gradient L2 change %.3g, %d gates flipped"
              % (eps, np.linalg.norm(g - g0) / np.linalg.norm(g0), flips))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    t = sub.add_parser("trajectory")
    t.add_argument("--package", choices=("port", "jax"), default="port")
    t.add_argument("--batch", type=int, default=16)
    t.add_argument("--size", type=int, default=224)
    t.add_argument("--steps", type=int, default=10)
    sub.add_parser("gate-flips")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    (trajectory if args.what == "trajectory" else gate_flips)(args)


if __name__ == "__main__":
    main()
