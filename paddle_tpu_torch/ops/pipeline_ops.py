"""The ``pipeline`` op rule (``layers.Pipeline``).

The port's counterpart of the JAX package's ``ops/pipeline_ops.py``, its
single-device branch: the batch is split into M microbatches (the side
inputs with it), and each microbatch runs the S virtual stages in
sequence, stage v through the sub-block with its slice of every stacked
parameter (row ``circular_stage_index(v, S // R, R)`` under
``circular_repeats`` R > 1, else row v).  The microbatch loop takes the
place of the JAX package's ``lax.map``.

Each stacked parameter is unbound once per run (views, no copy), so a
stage reads its slice without copying the stack, and autograd stacks
each parameter's gradient once.  The backward is the executor's
backward meta-op: ``torch.autograd.grad`` through those slices.  Every
operation runs on the device, so a Program holding the op binds and
replays as one CUDA graph.

An executor mesh with a ``pp`` axis is the opt-in to the multi-rank
schedules (``parallel/pipeline.py``), as in the JAX package: the GPipe
engine when the axis size is ``num_stages`` (no repeats), the circular
one when it is ``num_stages / circular_repeats``.  Each rank's stage
runs the sub-block with its slice of the stacked parameters; under the
executor's mesh step those are split over the ``pp`` ranks, and each
rank reads its own block.
"""
from __future__ import annotations

import torch

from ..parallel.pipeline import circular_stage_index
from ..registry import register


@register("pipeline")
def _pipeline(ctx, op):
    from ..executor import interpret_ops

    x = ctx.get_input(op, "X")
    params = ctx.get_inputs(op, "Params")   # each stacked [S, ...]
    side_vals = ctx.get_inputs(op, "Sides")  # each [B, ...], microbatch-sliced
    sub = op.sub_block
    a = op.attrs
    S = int(a["num_stages"])          # VIRTUAL stages
    M = int(a["num_microbatches"])
    R = int(a.get("circular_repeats", 1))
    n_dev = S // R                    # physical pp devices the layout maps to
    locals_ = list(a["param_locals"])
    side_locals = list(a.get("side_locals") or [])
    in_local, out_local = a["input_local"], a["output_local"]

    B = int(x.shape[0])
    if B % M:
        raise ValueError(
            "pipeline batch %d is not divisible by num_microbatches %d"
            % (B, M))
    mesh = ctx.mesh
    pp = mesh.axis_size("pp") if mesh is not None else 0
    if pp > 1 and ((R > 1 and pp == n_dev) or (R == 1 and pp == S)):
        from ..parallel import pipeline as engines
        from ..parallel.sharded import gathered

        def stage_fn(pdict, h, side, device):
            env = dict(ctx.env)
            env.update(pdict)
            env.update(side)
            env[in_local] = h
            c = ctx.child(env)
            c.device = device
            interpret_ops(c, sub.ops)
            if env[out_local].shape != h.shape:
                raise ValueError(
                    "pipeline stages must preserve the activation shape "
                    "(homogeneous contract): input %s vs output %s"
                    % (tuple(h.shape), tuple(env[out_local].shape)))
            return env[out_local]

        stacked = dict(zip(locals_, params))
        sides = {n: gathered(v) for n, v in zip(side_locals, side_vals)}
        if R > 1:
            out = engines.pipeline_apply_circular(
                stage_fn, stacked, x, mesh, M, R, axis_name="pp",
                side_inputs=sides)
        else:
            out = engines.pipeline_apply(stage_fn, stacked, x, mesh, M,
                                         axis_name="pp", side_inputs=sides)
        ctx.set_output(op, "Out", out)
        return
    from ..parallel.sharded import gathered

    slices = {n: gathered(p).unbind(0) for n, p in zip(locals_, params)}
    rows = [circular_stage_index(v, n_dev, R) if R > 1 else v
            for v in range(S)]
    mb = B // M
    xs = x.reshape((M, mb) + tuple(x.shape[1:])).unbind(0)
    sides = [(n, v.reshape((M, mb) + tuple(v.shape[1:])).unbind(0))
             for n, v in zip(side_locals, side_vals)]

    outs = []
    for m in range(M):
        h = xs[m]
        for i in rows:
            env = dict(ctx.env)
            env.update({n: s[i] for n, s in slices.items()})
            env.update({n: v[m] for n, v in sides})
            env[in_local] = h
            interpret_ops(ctx.child(env), sub.ops)
            if env[out_local].shape != h.shape:
                raise ValueError(
                    "pipeline stages must preserve the activation shape "
                    "(homogeneous contract): input %s vs output %s"
                    % (tuple(h.shape), tuple(env[out_local].shape)))
            h = env[out_local]
        outs.append(h)
    ctx.set_output(op, "Out", torch.cat(outs, 0))
