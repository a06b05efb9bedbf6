"""Switch-style Mixture-of-Experts: the dense reference and the stacked
expert layout.

The port's counterpart of the JAX package's ``parallel/moe.py``.  The
``switch_moe`` op rule (``ops/moe_ops.py``) computes the dense top-1
branch on one device; ``switch_moe_dense_reference`` is the per-token
reference the tests hold it to, and ``moe_expert_params`` stacks
per-expert parameters on a leading ``[E]`` axis.  The expert-parallel
engine (one expert a device, tokens shipped by two ``all_to_all``s with
capacity ``capacity_factor`` and the Switch overflow-drop rule) waits
for ROADMAP A11.2.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["moe_expert_params", "switch_moe_dense_reference"]


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
