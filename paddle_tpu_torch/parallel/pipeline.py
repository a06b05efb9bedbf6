"""Pipeline parallelism over a mesh axis: the GPipe and circular
schedules.

The port's counterpart of the JAX package's ``parallel/pipeline.py``.
Each rank of the ``pp`` axis holds its stage's slice of the stacked
parameters, and microbatches move along the ``s -> s+1`` ring of ranks,
the round wrap ``S-1 -> 0`` included under the circular layout.  Stage
``S-1``'s outputs are then broadcast to every rank, as the JAX package's
``psum`` does.

- :func:`pipeline_apply`: GPipe fill-drain.  With S stages and M
  microbatches the schedule runs ``M + S - 1`` ticks; at tick ``t``
  rank ``s`` applies its stage to microbatch ``t - s``.  Bubble
  ``(S-1)/(M+S-1)``.
- :func:`pipeline_apply_circular`: ``L = S * repeats`` virtual stages on
  S ranks; rank ``d`` hosts virtual stages ``d, d+S, d+2S, ...``, stored
  device-major (:func:`circular_stage_index`).  Microbatch ``g = w*S +
  m`` enters rank 0 at tick ``w*L + m`` and virtual stage ``v`` runs at
  tick ``w*L + m + v``: waves of S microbatches stream back to back,
  bubble ``(S-1)/(M*repeats + S-1)``.

A tick runs only the stages that hold a microbatch: the JAX package's
scan also computes fill and drain ticks on stand-in inputs and throws
their outputs away, which changes no number.  On the card each rank's
stage runs on its own CUDA stream, leased from ``streams.py``, so that
the stages of one tick can overlap; every stream forks from the calling
stream at the start of the tick and joins it at the end, and the
stages' outputs are marked as used on the calling stream, which reads
them after the join (``collective.RankStreams``).  Autograd goes
through the schedule: the backward of each stage runs on the stream of
its forward.
"""
from __future__ import annotations

import torch

from . import collective

__all__ = ["circular_stage_index", "pipeline_apply", "pipeline_apply_circular"]


def circular_stage_index(v, n_devices, repeats):
    """Storage row of virtual stage ``v`` in the device-major stacked layout
    used by the circular schedule: device ``v % S`` holds its ``repeats``
    slices contiguously, so a plain split of the leading dim over the
    ``pp`` devices hands each device exactly its rows.  The sequential
    path reads the same rows, so both paths see identical weights."""
    return (v % n_devices) * repeats + v // n_devices


def _schedule(stage_fn, slices, x, devs, M, R, side_inputs):
    """The tick loop both schedules share.  ``slices[s][j]`` is rank
    ``s``'s j-th stage parameter dict.  Returns the output batch on x's
    device."""
    S = len(devs)
    L = S * R
    B = x.shape[0]
    mb = B // M
    xs = x.reshape((M, mb) + tuple(x.shape[1:])).unbind(0)
    sides = {n: v.reshape((M, mb) + tuple(v.shape[1:])).unbind(0)
             for n, v in (side_inputs or {}).items()}

    def entry(g):
        return (g // S) * L + g % S

    last = entry(M - 1) + L - 1
    held = {}      # microbatch -> activation on the rank of its next stage
    outs = [None] * M
    streams = collective.RankStreams(devs, "pipeline stages")
    try:
        for u in range(last + 1):
            jobs = []
            for g in range(M):
                v = u - entry(g)
                if 0 <= v < L:
                    jobs.append((v % S, v, g))
            streams.fork()
            done = []
            for s, v, g in jobs:
                h = xs[g].to(devs[s]) if v == 0 else held.pop(g)
                side = {n: t[g].to(devs[s]) for n, t in sides.items()}
                params = slices[s][v // S]
                streams.use(s, [h, *side.values(), *params.values()])
                with streams.on(s):
                    out = stage_fn(params, h, side, devs[s])
                done.append((s, v, g, out))
            streams.join([out for *_, out in done])
            for s, v, g, out in done:
                if v == L - 1:
                    outs[g] = out
                else:   # the s -> s+1 ring, S-1 wrapping to 0
                    held[g] = out.to(devs[(s + 1) % S])
    finally:
        streams.release()
    # stage S-1's outputs, broadcast to every rank
    ys = torch.cat(outs, 0)
    return ys.to(x.device)


def _rank_slices(stacked, devs, R):
    """``slices[s][j]``: rank ``s``'s j-th stage parameters, from each
    stacked value (a tensor, or a ``ShardedTensor`` split on its leading
    axis over the ranks, whose block ``s`` is rank ``s``'s rows)."""
    from .sharded import ShardedTensor

    S = len(devs)
    out = [[{} for _ in range(R)] for _ in range(S)]
    for n, p in stacked.items():
        for s in range(S):
            if isinstance(p, ShardedTensor) and p.splits()[0] == S:
                rows = p.blocks[(s,) + (0,) * (p.ndim - 1)]
            else:
                rows = p[s * R:(s + 1) * R]
            rows = rows if rows.device == devs[s] else rows.to(devs[s])
            for j, t in enumerate(rows.unbind(0)):
                out[s][j][n] = t
    return out


def pipeline_apply(stage_fn, stacked_params, x, mesh, n_microbatches,
                   axis_name="pp", side_inputs=None):
    """Run ``x`` through the S-stage GPipe pipeline over ``axis_name``.

    ``stage_fn(params_slice, activation, sides, device) -> activation``;
    ``stacked_params`` a dict of values with leading dim S; ``x`` the
    whole batch ``[B, ...]`` with ``B % n_microbatches == 0``;
    ``side_inputs`` a dict of ``[B, ...]`` companions each stage reads
    for the microbatch it holds.  Returns the whole output batch."""
    devs = collective.axis_devices(mesh, axis_name)
    B, M = x.shape[0], int(n_microbatches)
    if B % M:
        raise ValueError("batch %d %% microbatches %d != 0" % (B, M))
    collective.count_engine("gpipe")
    return _schedule(stage_fn, _rank_slices(stacked_params, devs, 1), x,
                     devs, M, 1, side_inputs)


def pipeline_apply_circular(stage_fn, stacked_params, x, mesh, n_microbatches,
                            repeats, axis_name="pp", side_inputs=None):
    """The circular (interleaved) pipeline: ``L = S * repeats`` virtual
    stages on the S ranks of ``axis_name``, ``stacked_params`` in the
    device-major layout of :func:`circular_stage_index` (leading dim L),
    microbatches in waves of S."""
    devs = collective.axis_devices(mesh, axis_name)
    S, R = len(devs), int(repeats)
    L = S * R
    B, M = x.shape[0], int(n_microbatches)
    if B % M:
        raise ValueError("batch %d %% microbatches %d != 0" % (B, M))
    if M % S:
        raise ValueError(
            "circular schedule needs microbatches (%d) in waves of the pp "
            "size (%d)" % (M, S))
    lead = next(iter(stacked_params.values())).shape[0]
    if lead != L:
        raise ValueError(
            "circular stacked_params leading dim %d != S*repeats = %d"
            % (lead, L))
    collective.count_engine("circular")
    return _schedule(stage_fn, _rank_slices(stacked_params, devs, R), x,
                     devs, M, R, side_inputs)
