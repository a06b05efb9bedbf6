"""Switch-style Mixture-of-Experts: the dense reference and the stacked
expert layout.

The port's counterpart of the JAX package's ``parallel/moe.py``.  The
``switch_moe`` op rule (``ops/moe_ops.py``) computes the dense top-1
branch on one device; ``switch_moe_dense_reference`` is the per-token
reference the tests hold it to, and ``moe_expert_params`` stacks
per-expert parameters on a leading ``[E]`` axis.

:func:`switch_moe` is the expert-parallel engine over an ``ep`` mesh
axis (the rule takes it when the axis size is the expert count): each
rank owns one expert FFN and a batch shard of the tokens, and routing is
two ``all_to_all``s around the expert application:

1. gate: ``softmax(x @ gate_w)`` a token, top-1 expert choice;
2. dispatch: tokens packed into each expert's capacity slots
   ``C = ceil(capacity_factor * t_local / E)`` (``[E, C, D]``, a one-hot
   product); a token past its expert's capacity is DROPPED: its combine
   weight is zero, the Switch overflow rule;
3. the first ``all_to_all`` ships the slot buffers so that rank ``e``
   holds every shard's slots for expert ``e``; the expert runs one
   batched FFN; the second ships the results back;
4. combine: each kept token reads its expert's output scaled by its
   gate probability (so the gate's gradient flows through the combine).

Its products are ``torch.einsum`` (cuBLAS on the card), as the JAX
package's are ``jnp.einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from . import collective

__all__ = ["switch_moe", "moe_expert_params", "switch_moe_dense_reference",
           "dropped_tokens"]


def switch_moe_dense_reference(x, gate_w, expert_params, expert_fn):
    """Per-token dense top-1 reference for ``switch_moe`` (no dispatch, no
    capacity): every token runs its argmax expert, scaled by the gate
    prob.  ``x`` [B, D] and ``gate_w`` [D, E] as arrays or tensors,
    ``expert_params`` a dict of arrays stacked with a leading E axis,
    ``expert_fn(params_slice, tokens [n, D]) -> [n, D]`` on tensors;
    returns a numpy array."""
    x = torch.as_tensor(np.asarray(x))
    params = {k: torch.as_tensor(np.asarray(v)) for k, v in expert_params.items()}
    probs = torch.softmax(x @ torch.as_tensor(np.asarray(gate_w)), dim=-1)
    choice = probs.argmax(-1)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        e = int(choice[t])
        p = {k: v[e] for k, v in params.items()}
        out[t] = probs[t, e] * expert_fn(p, x[t:t + 1])[0]
    return out.numpy()


def moe_expert_params(per_expert):
    """[dict of arrays per expert] -> one dict, each array stacked on a
    leading E axis."""
    return {k: np.stack([np.asarray(e[k]) for e in per_expert])
            for k in per_expert[0]}


def _route(xs, gate_w, E, C):
    """One shard's routing: (slot one-hot [t, E, C], gate prob [t], kept
    [t] bool) of tokens ``xs`` [t, D]."""
    probs = torch.softmax(xs @ gate_w, dim=-1)                # [t, E]
    expert = probs.argmax(-1)                                 # [t]
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, E).to(torch.int32)
    pos = (torch.cumsum(onehot, 0) * onehot - 1).amax(1)      # slot a token
    keep = (pos >= 0) & (pos < C)
    slot = (torch.nn.functional.one_hot(expert, E).to(xs.dtype)[:, :, None]
            * torch.nn.functional.one_hot(torch.where(keep, pos, 0), C)
            .to(xs.dtype)[:, None, :]) * keep[:, None, None].to(xs.dtype)
    return slot, gate, keep


def _check(x, gate_w, lead, E, axis_name):
    B = x.shape[0]
    if B % E:
        raise ValueError("token count %d %% ep size %d != 0" % (B, E))
    if gate_w.shape[1] != E:
        # extra gate columns would silently zero every token routed past E
        raise ValueError(
            "gate_w has %d expert columns but the %r axis has %d devices"
            % (gate_w.shape[1], axis_name, E))
    if lead != E:
        raise ValueError(
            "expert_params leading dim %d != ep size %d" % (lead, E))


def switch_moe(x, gate_w, expert_params, expert_fn, mesh, axis_name="ep",
               capacity_factor=2.0):
    """``x`` [B, D] (split over ``axis_name``'s ranks on dim 0) -> [B, D].

    ``gate_w`` [D, E]; ``expert_params`` a dict of tensors stacked with a
    leading E equal to the axis size; ``expert_fn(params_slice, tokens
    [n, D]) -> [n, D]``.  Rank ``e`` of the axis holds expert ``e``."""
    devs = collective.axis_devices(mesh, axis_name)
    E = len(devs)
    lead = next(iter(expert_params.values())).shape[0]
    _check(x, gate_w, lead, E, axis_name)
    collective.count_engine("ep")
    t_local = x.shape[0] // E
    C = int(np.ceil(capacity_factor * t_local / E))
    D = x.shape[-1]
    xs = [c.to(d) for c, d in zip(x.chunk(E, 0), devs)]
    routes, dispatch = [], []
    for xe, d in zip(xs, devs):
        slot, gate, keep = _route(xe, gate_w.to(d), E, C)
        routes.append((slot, gate, keep))
        dispatch.append(torch.einsum("tec,td->ecd", slot, xe))  # [E, C, D]
    # rank e ends up with every shard's slots for ITS expert
    recv = collective.all_to_all(dispatch, split_axis=0, concat_axis=0)
    hidden = []
    for e, (r, d) in enumerate(zip(recv, devs)):
        mine = {k: v[e].to(d) for k, v in expert_params.items()}
        hidden.append(expert_fn(mine, r.reshape(E * C, D)).reshape(E, C, -1))
    # ship the results back to the tokens' owners
    back = collective.all_to_all(hidden, split_axis=0, concat_axis=0)
    outs = []
    for (slot, gate, keep), b in zip(routes, back):
        o = torch.einsum("tec,ecd->td", slot, b)
        outs.append(o * (gate * keep.to(gate.dtype))[:, None])
    return torch.cat([o.to(x.device) for o in outs], 0)


def dropped_tokens(x, gate_w, E, capacity_factor=2.0):
    """Tokens ``switch_moe`` over E ranks drops at ``capacity_factor``:
    those past their expert's capacity in their rank's shard."""
    C = int(np.ceil(capacity_factor * (x.shape[0] // E) / E))
    with torch.no_grad():
        return int(sum(int((~_route(xe, gate_w, E, C)[2]).sum())
                       for xe in x.chunk(E, 0)))
