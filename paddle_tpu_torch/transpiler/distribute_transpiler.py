"""DistributeTranspiler (reference:
python/paddle/fluid/transpiler/distribute_transpiler.py).

The port's copy of the JAX package's ``transpiler/distribute_transpiler.py``.
It splits a single-node training Program into:
- a *trainer* program: forward + backward, optimizer ops replaced by one
  ``send`` op (grads -> pserver shards) and one ``recv`` op (fresh params
  <- pservers).  The Executor runs the compute as one bound step (one
  CUDA graph on the card) and then the send/recv round on the host
  (``pserver_runtime.run_trainer_step``);
- per-endpoint *pserver* programs: a single ``listen_and_serv`` op whose
  sub-block holds the optimizer ops for the params sharded onto that
  endpoint.  ``Executor.run(pserver_program)`` enters the serve loop, as
  in the reference, and applies the sub-block on the pserver's device.

Sharding is whole-parameter by default (RoundRobin/HashName over params).
With ``config.slice_var_up = True`` any parameter big enough (>=
min_block_size elements and >= 2 rows) is split into row slices spread
over every pserver, so one huge embedding can't hotspot a single
endpoint.  Each slice gets its own optimizer-op instance and per-slice
optimizer state on its pserver; the trainer's send slices grads
row-wise, and recv writes the fresh slices back row range by row range.

One departure from the JAX package (R-13): an optimize op may read a
value that the forward computes and that is neither a param, a grad nor
persistable on the pserver, such as a learning-rate schedule's output
(Transformer-base's noam decay).  Nothing on the reference's pserver
writes it, so its apply fails.  Here the transpiler lists such values as
``forward_values`` on ``send`` and on ``listen_and_serv``: the trainer
fetches them with its gradients and sends them in the same round, and
the pserver feeds them to its apply.
"""
from __future__ import annotations

import numpy as np

from ..framework import OpRole, Program
from .ps_dispatcher import RoundRobin

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]


class DistributeTranspilerConfig:
    slice_var_up = False  # opt-in row-slice sharding of large params
    split_method = RoundRobin
    min_block_size = 8192


def _optimize_ops(program):
    return [op for op in program.global_block().ops if op.attrs.get("op_role") == OpRole.Optimize]


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()

    def transpile(
        self,
        trainer_id,
        program=None,
        pservers="127.0.0.1:6174",
        trainers=1,
        sync_mode=True,
        startup_program=None,
    ):
        from ..framework import default_main_program, default_startup_program

        self.trainer_id = trainer_id
        self.trainers = trainers
        self.sync_mode = sync_mode
        self.origin_program = program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self.pserver_endpoints = [ep.strip() for ep in pservers.split(",") if ep.strip()]

        opt_ops = _optimize_ops(self.origin_program)
        # (param, grad) names handled by each optimize op
        self.param_opt_ops = []  # [(param_name, grad_name, op)]
        for op in opt_ops:
            if "Param" in op.inputs and "Grad" in op.inputs:
                self.param_opt_ops.append((op.inputs["Param"][0], op.inputs["Grad"][0], op))

        # R-13: the values the optimize ops read that the forward
        # computes (not a param, not a grad, not persistable on the
        # pserver); the trainer sends them with its gradients
        src_vars = self.origin_program.global_block().vars
        handled = {n for p, g, _ in self.param_opt_ops for n in (p, g)}
        self.forward_values = sorted({
            n for _, _, op in self.param_opt_ops
            for n in op.all_input_names()
            if n not in handled and n in src_vars
            and not src_vars[n].persistable})

        dispatcher = self.config.split_method(self.pserver_endpoints)
        params = [self.origin_program.global_block().vars[p] for p, _, _ in self.param_opt_ops]
        eps = dispatcher.dispatch(params)
        self.param_ep = {p.name: ep for p, ep in zip(params, eps)}

        # slice_var_up: big params -> one row-slice per pserver.
        # self.param_slices[pname] = [(slice_name, ep, row0, row1), ...]
        # (unsliced params get a single full-range slice under their own name)
        n_eps = len(self.pserver_endpoints)
        self.param_slices = {}
        for p, ep in zip(params, eps):
            rows = p.shape[0] if p.shape else 0
            numel = int(np.prod(p.shape)) if p.shape else 0
            if (getattr(self.config, "slice_var_up", False) and n_eps > 1
                    and rows >= n_eps and numel >= self.config.min_block_size):
                bounds = [int(round(i * rows / n_eps)) for i in range(n_eps + 1)]
                self.param_slices[p.name] = [
                    ("%s.block%d" % (p.name, i), self.pserver_endpoints[i],
                     bounds[i], bounds[i + 1])
                    for i in range(n_eps) if bounds[i + 1] > bounds[i]
                ]
            else:
                self.param_slices[p.name] = [(p.name, ep, 0, rows)]

    # -- trainer side --------------------------------------------------------
    def get_trainer_program(self):
        p = self.origin_program.clone()
        blk = p.global_block()
        # drop every optimize-role op (incl. lr schedulers that feed them)
        blk.ops = [op for op in blk.ops if op.attrs.get("op_role") != OpRole.Optimize]
        grad_ep = {}
        param_ep = {}
        grad_slices = {}   # grad name  -> [(slice_grad_name, ep, r0, r1)]
        param_slices = {}  # param name -> [(slice_param_name, ep, r0, r1)]
        for param, grad, _op in self.param_opt_ops:
            slices = self.param_slices[param]
            grad_ep[grad] = slices[0][1]
            param_ep[param] = slices[0][1]
            param_slices[param] = slices
            grad_slices[grad] = [
                (grad if sn == param else sn.replace(param, grad, 1), ep, r0, r1)
                for sn, ep, r0, r1 in slices
            ]
        blk.append_op(
            type="send",
            inputs={"X": sorted(grad_ep)},
            outputs={},
            attrs={
                "epmap": [grad_ep[g] for g in sorted(grad_ep)],
                "endpoints": self.pserver_endpoints,
                "sync_mode": self.sync_mode,
                "slices": grad_slices,
                "trainer_id": self.trainer_id,
                "forward_values": list(self.forward_values),
                "op_role": OpRole.RPC,
            },
        )
        blk.append_op(
            type="recv",
            inputs={},
            outputs={"Out": sorted(param_ep)},
            attrs={
                "epmap": [param_ep[pn] for pn in sorted(param_ep)],
                "endpoints": self.pserver_endpoints,
                "slices": param_slices,
                "op_role": OpRole.RPC,
            },
        )
        p._bump()
        return p

    def _slice_rename(self, op, pname, gname, slice_idx, sname, r0, r1):  # noqa: C901
        """Clone an optimize op for one param slice: Param/Grad and every
        per-param state var get slice names (row-sliced when their leading
        dim matches the param's); LearningRate and the forward values
        (R-13) stay shared."""
        src_blk = self.origin_program.global_block()
        p_var = src_blk.vars[pname]
        rows = p_var.shape[0]
        rename = {}
        shapes = {}
        for slot, names in list(op.inputs.items()) + list(op.outputs.items()):
            for n in names:
                if (n in rename or slot == "LearningRate"
                        or n in self.forward_values):
                    continue
                if n == pname:
                    rename[n] = sname
                    shapes[sname] = (r1 - r0,) + tuple(p_var.shape[1:])
                elif n == gname:
                    rename[n] = sname if sname == pname else sname.replace(pname, gname, 1)
                    shapes[rename[n]] = (r1 - r0,) + tuple(p_var.shape[1:])
                else:  # optimizer accumulator (velocity/moments/beta pows...)
                    v = src_blk.vars.get(n)
                    if v is None:
                        continue
                    rename[n] = "%s.block%d" % (n, slice_idx)
                    if v.shape and v.shape[0] == rows:
                        shapes[rename[n]] = (r1 - r0,) + tuple(v.shape[1:])
                    else:  # [1]-shaped state (beta pow): per-slice full copy
                        shapes[rename[n]] = tuple(v.shape) if v.shape else None
        self._slice_ranges.update(
            {new: (r0, r1) for orig, new in rename.items()
             if shapes.get(new) is not None and src_blk.vars.get(orig) is not None
             and src_blk.vars[orig].shape and src_blk.vars[orig].shape[0] == rows})
        new_inputs = {s: [rename.get(n, n) for n in ns] for s, ns in op.inputs.items()}
        new_outputs = {s: [rename.get(n, n) for n in ns] for s, ns in op.outputs.items()}
        return new_inputs, new_outputs, rename, shapes

    # -- pserver side --------------------------------------------------------
    def get_pserver_programs(self, endpoint):
        """(main, startup) pair for one pserver endpoint — the reference's
        convenience bundling of get_pserver_program + get_startup_program."""
        main = self.get_pserver_program(endpoint)
        return main, self.get_startup_program(endpoint, main)

    def get_pserver_program(self, endpoint):
        self._slice_ranges = {}  # slice var -> (r0, r1) for row-sliced vars
        prog = Program()
        blk = prog.global_block()
        src_blk = self.origin_program.global_block()

        opt_block = prog.create_block()
        var_shapes = {}   # var name -> sliced shape (None = copy source shape)
        var_sources = {}  # var name -> source var name
        grad_names = []
        param_names = []
        read = set()
        for pname, gname, op in self.param_opt_ops:
            for idx, (sname, ep, r0, r1) in enumerate(self.param_slices[pname]):
                if ep != endpoint:
                    continue
                read.update(op.all_input_names())
                if sname == pname:  # whole param, original names
                    param_names.append(pname)
                    grad_names.append(gname)
                    opt_block.append_op(
                        type=op.type, inputs=dict(op.inputs),
                        outputs=dict(op.outputs), attrs=dict(op.attrs))
                    for names in list(op.inputs.values()) + list(op.outputs.values()):
                        for n in names:
                            var_shapes.setdefault(n, None)
                            var_sources.setdefault(n, n)
                else:
                    ni, no, rename, shapes = self._slice_rename(
                        op, pname, gname, idx, sname, r0, r1)
                    sgname = ni["Grad"][0]
                    param_names.append(sname)
                    grad_names.append(sgname)
                    opt_block.append_op(
                        type=op.type, inputs=ni, outputs=no, attrs=dict(op.attrs))
                    for orig, new in rename.items():
                        var_shapes[new] = shapes.get(new)
                        var_sources[new] = orig
                    for names in list(ni.values()) + list(no.values()):
                        for n in names:
                            if n not in var_shapes and n in src_blk.vars:
                                var_shapes[n] = None
                                var_sources[n] = n
        for n in sorted(var_shapes):
            src_name = var_sources[n]
            if src_name in src_blk.vars:
                v = src_blk.vars[src_name]
                blk.create_var(
                    name=n,
                    shape=var_shapes[n] if var_shapes[n] is not None else v.shape,
                    dtype=v.dtype,
                    persistable=(n not in grad_names) and v.persistable,
                )
        prog.current_block_idx = 0
        # slice metadata for get_startup_program: slice name -> (source var,
        # sliced shape or None for an unsliced copy)
        prog._slice_vars = {
            n: (var_sources[n], var_shapes[n]) + self._slice_ranges.get(n, (None, None))
            for n in var_shapes if var_sources[n] != n
        }
        blk.append_op(
            type="listen_and_serv",
            inputs={},
            outputs={},
            attrs={
                "endpoint": endpoint,
                "Fanin": self.trainers,
                "sync_mode": self.sync_mode,
                "optimize_block": opt_block.idx,
                "sub_block": opt_block.idx,
                "grad_names": sorted(grad_names),
                "param_names": sorted(param_names),
                "forward_values": [n for n in self.forward_values
                                   if n in read],
                "op_role": OpRole.RPC,
            },
        )
        prog._bump()
        return prog

    def get_startup_program(self, endpoint, pserver_program, startup_program=None):
        """Init program for one pserver: the original startup ops whose outputs
        are persistable on that pserver (params + optimizer accumulators + lr)."""
        startup = startup_program or self.startup_program
        persistables = {
            v.name for v in pserver_program.list_vars() if v.persistable
        }
        slice_vars = getattr(pserver_program, "_slice_vars", {})
        by_source = {}
        for sname, (src_name, shape, r0, r1) in slice_vars.items():
            if sname in persistables:
                by_source.setdefault(src_name, []).append((sname, shape, r0, r1))
        p = Program()
        blk = p.global_block()
        src = startup.global_block()
        for op in src.ops:
            outs = [n for names in op.outputs.values() for n in names]
            if any(o in persistables for o in outs):
                for names in list(op.inputs.values()) + [outs]:
                    for n in names:
                        if n in src.vars and not blk.has_var(n):
                            v = src.vars[n]
                            blk.create_var(name=v.name, shape=v.shape, dtype=v.dtype, persistable=True)
                blk.append_op(type=op.type, inputs=dict(op.inputs), outputs=dict(op.outputs), attrs=dict(op.attrs))
            # sliced targets: clone the initializer per slice with the slice's
            # shape (row-sliced init is distributionally identical; constants
            # are exact)
            for o in outs:
                for sname, shape, r0, r1 in by_source.get(o, []):
                    sv = src.vars.get(o)
                    if sv is not None and not blk.has_var(sname):
                        blk.create_var(name=sname, shape=shape or sv.shape,
                                       dtype=sv.dtype, persistable=True)
                    attrs = dict(op.attrs)
                    if shape is not None and "shape" in attrs:
                        attrs["shape"] = list(shape)
                    if r0 is not None and "values" in attrs:
                        # assign_value-style init: the slice gets its own rows
                        vals = np.asarray(attrs["values"])
                        if vals.ndim >= 1 and sv is not None and sv.shape and vals.shape[0] == sv.shape[0]:
                            attrs["values"] = vals[r0:r1]
                    blk.append_op(
                        type=op.type, inputs=dict(op.inputs),
                        outputs={k: [sname if n == o else n for n in ns]
                                 for k, ns in op.outputs.items()},
                        attrs=attrs)
        p._bump()
        return p
