"""Tensor-parallel layouts: which state is split over the ``tp`` axis.

The port's counterpart of the JAX package's ``parallel/tp.py``.  A spec
is a tuple of axis names or ``None`` (``parallel.sharded``), the port's
stand-in for a ``PartitionSpec``.  ``make_param_shardings`` gives each
state entry its spec:

- explicit ``rules`` (``[(regex, spec)]``) win, the first that matches;
- otherwise the reference's Megatron-style heuristic: a 2-D ``[in, out]``
  weight is column-split on ``tp`` when its output dim divides, else
  row-split when its input dim divides, else replicated; every other
  value is replicated.

In the port tp is a layout of the state, not a split of the compute:
each tp rank holds its block, and the executor's mesh step gathers a
parameter where it is used (ROADMAP R-10).
"""
from __future__ import annotations

import re

import numpy as np

__all__ = ["make_param_shardings", "shard_feeds", "replicated"]


def replicated(mesh=None):
    """The spec of a replicated value."""
    return ()


def _spec(s):
    if s is None:
        return ()
    return tuple(s)


def make_param_shardings(state, mesh, rules=None, tp_axis="tp"):
    """``{name: array}`` -> ``{name: spec}`` (see the module docstring)."""
    tp = mesh.axis_size(tp_axis) if tp_axis in mesh.axis_names else 1
    compiled = [(re.compile(pat), spec) for pat, spec in (rules or [])]
    out = {}
    for name, val in state.items():
        spec = None
        for pat, s in compiled:
            if pat.search(name):
                spec = _spec(s)
                break
        if spec is None:
            shape = tuple(np.shape(val)) if not hasattr(val, "shape") else tuple(val.shape)
            if tp > 1 and len(shape) == 2:
                if shape[1] % tp == 0 and shape[1] >= tp:
                    spec = (None, tp_axis)  # column parallel
                elif shape[0] % tp == 0 and shape[0] >= tp:
                    spec = (tp_axis, None)  # row parallel
                else:
                    spec = ()
            else:
                spec = ()
        out[name] = spec
    return out


def shard_feeds(feeds, mesh, dp_axis="dp"):
    """Batch-split every feed on the data-parallel axis."""
    return {k: (dp_axis,) for k in feeds}
