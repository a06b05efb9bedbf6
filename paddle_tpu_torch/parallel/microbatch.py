"""Pipeline-style microbatching: gradient accumulation over microbatches.

The port's counterpart of the JAX package's ``parallel/microbatch.py``
(reference analog: none — gradient accumulation appeared in later
Paddle versions).  The global batch splits into k microbatches; each
runs the forward prefix and ``torch.autograd.grad`` of its loss, and the
parameter gradients add up (activation memory is one microbatch's).  The
optimizer ops then run once, on the averaged gradients.  Persistable
side state (BN running stats, step counters) threads through the
microbatches in order, so the semantics are those of running them one
after another.  A loop over the microbatches takes the place of the JAX
package's ``lax.scan``.

It follows ``program_fn.program_to_fn``'s conventions: state and feeds
are dicts of tensors or arrays, ``seed`` keys the random ops (microbatch
i runs as step i of that seed), and ``device=None`` is the card.

One departure from the JAX package (ROADMAP R-9): the optimizer ops also
get the values they read from the forward prefix that are not state —
a learning-rate schedule's, as Transformer-base's noam decay computes
it — from the last microbatch's run; the JAX package's function raises
``KeyError`` for such a Program.  A step counter in the prefix counts
each microbatch, as the JAX package threads it through its scan.
"""
from __future__ import annotations

import torch

from ..core import f32_bf16_reduction, resolve_device
from ..executor import LoweringContext, _as_tensor, _ops_read_names, interpret_ops
from ..framework import Program, Variable, grad_var_name

__all__ = ["program_to_microbatched_fn"]


def program_to_microbatched_fn(program: Program, fetch_list, num_microbatches: int,
                               device=None):
    """Build ``fn(state, feeds, seed=0) -> (fetches, new_state)``.

    Feeds' leading (batch) dim must divide by ``num_microbatches``.  Fetches
    are stacked per microbatch on a new leading axis (average scalar losses
    over it).  Equivalent to the plain executor step whenever the loss is a
    batch mean (mean-of-means == full mean).
    """
    dev = resolve_device(device)
    fetch_names = [f.name if isinstance(f, Variable) else str(f) for f in fetch_list]
    persistable = program.persistable_names()

    block = program.global_block()
    bw_idx = next((i for i, op in enumerate(block.ops) if op.type == "backward"), None)
    if bw_idx is None:
        raise ValueError("program has no backward op — nothing to accumulate")
    pre, bop, post = block.ops[:bw_idx], block.ops[bw_idx], block.ops[bw_idx + 1:]
    post_reads = _ops_read_names(post)
    loss_name = bop.inputs["Loss"][0]
    no_grad = set(bop.attrs.get("no_grad_set") or ())
    param_names = [p for p in bop.attrs["parameter_list"] if p not in no_grad]
    k = int(num_microbatches)

    def fn(state, feeds, seed=0):
        sliced = {}
        for name, v in feeds.items():
            v = _as_tensor(v, None, dev)
            if v.shape[0] % k != 0:
                raise ValueError(
                    "feed %r batch %d not divisible by %d microbatches" % (name, v.shape[0], k)
                )
            sliced[name] = v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:])).unbind(0)
        state = {n: _as_tensor(v, None, dev) for n, v in state.items()}
        p0 = {p: state[p] for p in param_names}
        aux = {n: v for n, v in state.items() if n in persistable and n not in p0}
        grads = {p: torch.zeros(v.shape, dtype=torch.promote_types(v.dtype, torch.float32),
                                device=dev) for p, v in p0.items()}
        fetches = [[] for _ in fetch_names]
        with f32_bf16_reduction(dev):
            for i in range(k):
                leaves = {p: v.detach().requires_grad_(True) for p, v in p0.items()}
                env = dict(aux)
                env.update(leaves)
                env.update({n: s[i] for n, s in sliced.items()})
                ctx = LoweringContext(program, env, dev, seed=seed, step=i,
                                      keep_names=fetch_names)
                with torch.enable_grad():
                    interpret_ops(ctx, pre)
                    loss = ctx.env[loss_name].float().sum()
                    gs = torch.autograd.grad(loss, list(leaves.values()),
                                             allow_unused=True)
                for p, g in zip(leaves, gs):
                    if g is not None:
                        grads[p] += g
                aux = {n: ctx.env[n].detach() for n in aux}
                for j, n in enumerate(fetch_names):
                    fetches[j].append(ctx.env[n].detach())
                # what the optimizer ops read of the prefix's values (a
                # learning-rate schedule's), from the last microbatch
                carried = {n: v.detach() for n, v in ctx.env.items()
                           if n in post_reads and n not in aux and n not in p0
                           and isinstance(v, torch.Tensor)}
                del ctx, env, leaves, loss, gs

            # optimizer ops once, on averaged grads
            env = dict(carried)
            env.update(aux)
            env.update(p0)
            for p in param_names:
                env[grad_var_name(p)] = (grads[p] / k).to(state[p].dtype)
            ctx = LoweringContext(program, env, dev, seed=seed, step=k)
            with torch.no_grad():
                interpret_ops(ctx, post)
        new_state = {n: v for n, v in ctx.env.items() if n in persistable}
        for n in state:
            new_state.setdefault(n, ctx.env.get(n, state[n]))
        return [torch.stack(f) for f in fetches], new_state

    return fn
