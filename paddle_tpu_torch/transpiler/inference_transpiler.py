"""InferenceTranspiler (reference:
python/paddle/fluid/transpiler/inference_transpiler.py).

Folds a batch_norm into the conv2d, depthwise_conv2d or mul right before
it, for a Program run for test (batch_norm on its running statistics):

    k  = Scale / sqrt(Variance + epsilon)
    w' = w * k                      (per output channel or column)
    b' = b * k + Bias - Mean * k    (b = 0 where the op has no Bias)

The op then writes the batch_norm's ``Y`` itself, with ``b'`` as its
``Bias`` input, and the batch_norm is gone.  The folded Program computes
what the unfolded one does, up to float32 rounding.

The JAX package's fold differs here: it gives a conv without a bias a
``Bias`` input holding the shift, but its conv2d and mul rules never read
``Bias``, so its folded Program drops ``Bias - Mean * k``.  A folded
model that this port saves therefore computes differently when the JAX
package loads it.
"""
from __future__ import annotations

import torch

__all__ = ["InferenceTranspiler"]

_OUT_SLOT = {"conv2d": "Output", "depthwise_conv2d": "Output", "mul": "Out"}
_WEIGHT_SLOT = {"conv2d": "Filter", "depthwise_conv2d": "Filter", "mul": "Y"}


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        """Fold each batch_norm of ``program``'s global block into the
        conv2d/depthwise_conv2d/mul that writes its only input (and whose
        output nothing else reads), in place, rewriting the weights in
        ``scope`` (default: the global scope).  ``place`` is accepted for
        the reference's signature: the weights stay on their device.
        Returns ``program``."""
        from ..executor import global_scope

        scope = scope if scope is not None else global_scope()
        blk = program.global_block()
        ops = blk.ops
        readers = {}
        for op in ops:
            for n in op.all_input_names():
                readers[n] = readers.get(n, 0) + 1
        kept = []
        i = 0
        while i < len(ops):
            op, nxt = ops[i], ops[i + 1] if i + 1 < len(ops) else None
            slot = _OUT_SLOT.get(op.type)
            if (slot is not None and nxt is not None
                    and nxt.type == "batch_norm"
                    and nxt.inputs["X"][0] == op.outputs[slot][0]
                    and readers.get(op.outputs[slot][0]) == 1):
                self._fold(op, nxt, blk, scope)
                op.outputs[slot] = [nxt.outputs["Y"][0]]
                kept.append(op)
                i += 2
                continue
            kept.append(op)
            i += 1
        blk.ops = kept
        program._bump()
        return program

    @staticmethod
    def _fold(op, bn_op, blk, scope):
        """Scale ``op``'s weight and set its ``Bias`` to the batch_norm's
        shift, computed in float64 and stored in each tensor's dtype."""

        def get(name):
            owner = scope._owner(name)
            if owner is None or owner.vars[name] is None:
                raise KeyError("InferenceTranspiler: %r is not in the scope "
                               "(run the startup program first)" % name)
            return owner, owner.vars[name]

        def stat(slot):
            return torch.as_tensor(get(bn_op.inputs[slot][0])[1]).double()

        eps = float(bn_op.attrs.get("epsilon", 1e-5))
        k = stat("Scale") / torch.sqrt(stat("Variance") + eps)
        shift = stat("Bias") - stat("Mean") * k

        w_name = op.inputs[_WEIGHT_SLOT[op.type]][0]
        owner, w = get(w_name)
        w = torch.as_tensor(w)
        kw = k.to(w.device)
        kw = kw[None, :] if op.type == "mul" else kw[:, None, None, None]
        owner.vars[w_name] = (w.double() * kw).to(w.dtype)

        if op.inputs.get("Bias"):
            b_name = op.inputs["Bias"][0]
            owner, b = get(b_name)
            b = torch.as_tensor(b)
            owner.vars[b_name] = (b.double() * k.to(b.device)
                                  + shift.to(b.device)).to(b.dtype)
        else:
            b_name = w_name + ".bn_folded_bias"
            blk.create_var(name=b_name, shape=[int(shift.shape[0])],
                           dtype="float32", persistable=True)
            owner.vars[b_name] = shift.to(device=w.device,
                                          dtype=torch.float32)
            op.inputs["Bias"] = [b_name]
