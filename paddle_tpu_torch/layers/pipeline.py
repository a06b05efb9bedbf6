"""Pipeline parallelism through the Program API (``layers.Pipeline``).

The port's copy of the JAX package's ``layers/pipeline.py`` (reference
analog: none — Fluid v0.15 scales data-parallel only).  The user writes
ONE stage's computation as a sub-block; parameters created inside get a
leading ``[num_stages]`` axis (stacked — the homogeneous-pipeline
contract), and the emitted ``pipeline`` op (``ops/pipeline_ops.py``)
runs the stages in sequence on one device: the batch split into
``num_microbatches``, each microbatch through every stage; over a
``pp`` mesh axis it runs the GPipe or the circular schedule
(``parallel/pipeline.py``), each rank with its block of the stacked
parameters.

Example::

    pipe = layers.Pipeline(num_stages=4, num_microbatches=8)
    with pipe.stage():
        h = pipe.stage_input(x)          # [batch, d]
        y = layers.fc(h, size=d, act="tanh")
        pipe.stage_output(y)             # must keep h's shape
    out = pipe()                         # [batch, d]

Constraints (the homogeneous-pipeline contract): one activation in, one
activation out, same shape; every stage runs the same body with its own
slice of the stacked parameters.

Dropout inside a stage body draws ONE mask per op instance (its
generator is seeded from the op's position), so the same mask applies at
every stage and microbatch, as in the JAX package; a captured step gives
each repeated draw a generator of its own, seeded the same
(``executor.LoweringContext.op_generator``).

Ragged (LoD) tensors are not microbatch-sliced: keep stage bodies dense
(pad-mask via side inputs, as the transformer integration does).
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["Pipeline"]

# innermost-last stack of Pipelines whose stage block is being built;
# LayerHelper.create_parameter consults this to stack parameters
_ACTIVE = []


def active_pipeline():
    return _ACTIVE[-1] if _ACTIVE else None


class Pipeline:
    def __init__(self, num_stages, num_microbatches=None, name=None,
                 circular_repeats=1):
        """``circular_repeats=R`` opts into the interleaved (circular)
        layout: the ``num_stages`` virtual stages map to num_stages/R
        devices, each hosting R stage slices
        (``parallel.pipeline.circular_stage_index``).  On one device the
        stages run in sequence, virtual stage v reading that row."""
        if int(num_stages) < 1:
            raise ValueError("num_stages must be >= 1, got %s" % (num_stages,))
        if int(circular_repeats) < 1 or int(num_stages) % int(circular_repeats):
            raise ValueError(
                "circular_repeats %s must divide num_stages %s"
                % (circular_repeats, num_stages))
        self.helper = LayerHelper("pipeline", name=name)
        self.num_stages = int(num_stages)
        self.circular_repeats = int(circular_repeats)
        self.num_microbatches = int(num_microbatches or num_stages)
        n_dev = self.num_stages // self.circular_repeats
        if self.circular_repeats > 1 and self.num_microbatches % n_dev:
            raise ValueError(
                "num_microbatches %d must be a multiple of the pp device "
                "count %d (= num_stages %d / circular_repeats %d): the "
                "circular schedule streams microbatches in waves of the "
                "device count" % (self.num_microbatches, n_dev,
                                  self.num_stages, self.circular_repeats))
        self.in_stage = False
        self._block = None
        self._input = None          # (outer var, stage-local var)
        self._sides = []            # [(outer var, stage-local var)]
        self._output_local = None
        self._params = []           # [(stacked Parameter, local var name)]
        self._param_locals = {}     # stacked param name -> local var
        self.out_var = None

    # -- stage block ---------------------------------------------------------
    class _Guard:
        def __init__(self, pipe):
            self.pipe = pipe

        def __enter__(self):
            p = self.pipe
            if p.in_stage or p.out_var is not None:
                raise RuntimeError("Pipeline.stage() may be entered once")
            p._block = p.helper.main_program.create_block()
            p.in_stage = True
            _ACTIVE.append(p)
            return p

        def __exit__(self, exc_type, *a):
            p = self.pipe
            _ACTIVE.pop()
            p.in_stage = False
            if exc_type is not None:
                p.helper.main_program.rollback()
                return False
            try:
                p._complete()
            finally:
                # even when _complete raises (missing stage_input/output),
                # the current block must return to the parent, or every
                # later layer silently lands in the orphaned sub-block
                p.helper.main_program.rollback()
            return True

    def stage(self):
        return Pipeline._Guard(self)

    def stage_input(self, x):
        """Declare the activation entering each stage (the outer var ``x``
        enters stage 0; later stages receive the previous stage's output)."""
        if not self.in_stage:
            raise RuntimeError("stage_input() must be called inside `with pipe.stage()`")
        if self._input is not None:
            raise ValueError("Pipeline carries exactly one activation; "
                             "concat inputs outside the pipeline instead")
        local = self._block.create_var(
            name=self.helper.name + ".h", dtype=x.dtype,
            shape=(-1,) + tuple(x.shape[1:]) if x.shape else None,
        )
        self._input = (x, local)
        return local

    def stage_side_input(self, v):
        """Declare a batch-aligned companion every stage READS but none
        transforms (attention bias, masks, lengths...).  It is sliced to
        the in-flight microbatch alongside the activation — closing over
        the outer full-batch var instead would shape-mismatch the
        microbatched activation.  Batch-independent tensors (lookup
        tables, scalars) need no declaration: close over them freely."""
        if not self.in_stage:
            raise RuntimeError(
                "stage_side_input() must be called inside `with pipe.stage()`")
        local = self._block.create_var(
            name=self.helper.name + ".side%d" % len(self._sides), dtype=v.dtype,
            shape=(-1,) + tuple(v.shape[1:]) if v.shape else None,
        )
        self._sides.append((v, local))
        return local

    def stage_output(self, y):
        if not self.in_stage:
            raise RuntimeError("stage_output() must be called inside `with pipe.stage()`")
        if self._input is None:
            raise RuntimeError("call stage_input() before stage_output()")
        if tuple(y.shape[1:]) != tuple(self._input[1].shape[1:]):
            raise ValueError(
                "pipeline stages must preserve the activation shape "
                "(homogeneous contract): input %s vs output %s"
                % (self._input[1].shape, y.shape))
        self._output_local = y

    # called by LayerHelper.create_parameter while in_stage
    def _create_stage_parameter(self, helper, attr, shape, dtype):
        S = self.num_stages
        main_block = helper.main_program.global_block()
        existing = main_block.vars.get(attr.name)
        if existing is not None:
            # explicit ParamAttr name reuse inside the same pipeline:
            # hand back the same stage-local slice
            local = self._param_locals.get(attr.name)
            if local is None:
                raise ValueError(
                    "parameter %r already exists outside this pipeline; "
                    "pipeline-stacked parameters cannot be shared with "
                    "non-pipeline layers" % (attr.name,))
            return local
        stacked_shape = [S] + list(shape)
        param = main_block.create_parameter(
            shape=stacked_shape, dtype=dtype, **attr._to_kwargs())
        # marks the leading axis as a pipeline-stage axis: serialization
        # and clone carry this flag
        param.pp_stacked = True
        # initialize PER STAGE, then stack: running the initializer on the
        # [S]+shape twin would compute Xavier/MSRA fans from the stacked
        # 3-D/5-D shape (the conv-kernel rule) and mis-scale every draw;
        # each stage must get an independent draw with per-stage fans
        sb = helper.startup_program.global_block()
        slices = []
        for s in range(S):
            tw = sb.create_var(
                name=param.name + ".stage%d_init" % s, shape=list(shape),
                dtype=dtype)
            attr.initializer(tw, sb)
            slices.append(tw)
        stacked_twin = sb.create_var(
            name=param.name, shape=stacked_shape, dtype=dtype, persistable=True)
        sb.append_op(
            type="stack", inputs={"X": slices},
            outputs={"Y": [stacked_twin]}, attrs={"axis": 0})
        local = self._block.create_var(
            name=param.name + "@stage", dtype=dtype, shape=list(shape))
        self._params.append((param, local.name))
        self._param_locals[param.name] = local
        return local

    def _complete(self):
        if self._input is None or self._output_local is None:
            raise RuntimeError(
                "pipeline stage block needs stage_input() and stage_output()")
        main = self.helper.main_program
        blk = main.current_block()
        parent = main.block(blk.parent_idx)
        outer_x, local_in = self._input
        out = parent.create_var(
            name=self.helper.name + ".out", dtype=self._output_local.dtype,
            shape=outer_x.shape,
        )
        parent.append_op(
            type="pipeline",
            inputs={"X": [outer_x], "Params": [p for p, _ in self._params],
                    "Sides": [v for v, _ in self._sides]},
            outputs={"Out": [out]},
            attrs={
                "sub_block": blk.idx,
                "num_stages": self.num_stages,
                "num_microbatches": self.num_microbatches,
                "input_local": local_in.name,
                "output_local": self._output_local.name,
                "param_locals": [ln for _, ln in self._params],
                "side_locals": [lv.name for _, lv in self._sides],
                "circular_repeats": self.circular_repeats,
            },
        )
        self.out_var = out

    def __call__(self):
        if self.out_var is None:
            raise RuntimeError("Pipeline.stage() block was never completed")
        return self.out_var
