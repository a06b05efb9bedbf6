"""Control-flow layers (reference: python/paddle/fluid/layers/control_flow.py).

The port keeps ``equal`` so far (the Transformer's pad masks use it), a
copy of the JAX package's.  The other comparisons and the sub-block
constructs (While, IfElse, Switch, tensor arrays) are not ported yet.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["equal"]


def equal(x, y, cond=None, **ignored):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool", shape=x.shape)
        cond.stop_gradient = True
    helper.append_op(type="equal", inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]})
    return cond
