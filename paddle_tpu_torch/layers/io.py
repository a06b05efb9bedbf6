"""Data-side layers (reference: python/paddle/fluid/layers/io.py).

Copies of the JAX package's layers that need no reader runtime:
``data`` declares a feed slot, ``read_file`` hands out a reader's slots,
``random_data_generator`` is an in-graph uniform source, ``load`` builds
the load op (its rule waits for io, ROADMAP A6) and ``Preprocessor``
puts a reader's transform ops in the main graph.  The reader pipelines
(``py_reader``, ``double_buffer``, ``shuffle``, ``batch``) wait for the
port of the reader runtime (ROADMAP A6), and the recordio readers
(``open_recordio_file``, ``open_files``) for its recordio files (A12):
each raises ``NotImplementedError`` naming what it waits for.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["data", "read_file", "py_reader", "shuffle", "batch",
           "double_buffer", "open_recordio_file", "open_files",
           "random_data_generator", "load", "Preprocessor"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0, type=None, stop_gradient=True):
    """Declare an input slot. With append_batch_size (default, as reference
    layers/io.py:24) a leading -1 batch dim is added."""
    helper = LayerHelper("data")
    shape = list(shape)
    if lod_level >= 1:
        # padded-ragged layout: [batch, max_len] + per-timestep shape (the
        # reference's flat [sum_len]+lod becomes dense batch-major here)
        shape = [-1, -1] + shape
    elif append_batch_size:
        shape = [-1] + shape
    return helper.block.program.global_block().create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        lod_level=lod_level,
        is_data=True,
        stop_gradient=stop_gradient,
    )


def _not_ported(name, waits_for):
    raise NotImplementedError(
        "layers.%s is not ported to paddle_tpu_torch yet: it waits for %s"
        % (name, waits_for))


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    _not_ported("py_reader", "the reader runtime (ROADMAP A6)")


def double_buffer(reader, place=None, name=None):
    _not_ported("double_buffer", "the reader runtime (ROADMAP A6)")


def shuffle(reader, buffer_size):
    _not_ported("shuffle", "the reader runtime (ROADMAP A6)")


def batch(reader, batch_size):
    _not_ported("batch", "the reader runtime (ROADMAP A6)")


def open_recordio_file(filename, shapes, lod_levels, dtypes, pass_num=1,
                       for_parallel=True):
    _not_ported("open_recordio_file",
                "the reader runtime (A6) and recordio (A12)")


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=1,
               buffer_size=None, pass_num=1):
    _not_ported("open_files", "the reader runtime (A6) and recordio (A12)")


def read_file(reader):
    if hasattr(reader, "vars") and reader.vars is not None:
        return reader.vars
    return reader


def random_data_generator(low, high, shapes, lod_levels=None, for_parallel=True):
    """In-graph uniform random data source (reference io.py:413) — the
    debug/benchmark reader that needs no feeding: each slot is a
    uniform_random op over the full given shape."""
    from . import ops as op_layers

    class _RandomSource:
        def __init__(self, vars_):
            self.vars = vars_

    vars_ = [
        op_layers.uniform_random(list(shape), min=float(low), max=float(high))
        for shape in shapes
    ]
    return _RandomSource(vars_)


def load(out, file_path, load_as_fp16=None):
    """Load one variable's value from a file written by ``io.save_vars``
    (reference io.py:1069; kernel operators/load_op.cc)."""
    helper = LayerHelper("load")
    helper.append_op(
        type="load",
        inputs={},
        outputs={"Out": [out]},
        attrs={"file_path": file_path, "load_as_fp16": bool(load_as_fp16)},
    )
    return out


class Preprocessor:
    """In-graph reader preprocessing block (reference io.py:969).

    The reference builds a sub-block executed by a custom reader; here the
    reader slots are feed vars and the transform ops land directly in the
    main graph — ``inputs()`` hands out the underlying reader's slots,
    ``outputs(...)`` declares the transformed vars, and calling the
    preprocessor yields a reader whose ``read_file`` result is those
    outputs.
    """

    def __init__(self, reader, name=None):
        self._reader = reader
        self._in_block = False
        self._outs = None

    def block(self):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            self._in_block = True
            try:
                yield
            finally:
                self._in_block = False
            if not self._outs:
                raise RuntimeError(
                    "Preprocessor definition incomplete: call inputs() and "
                    "outputs(...) inside block()")

        return _ctx()

    def inputs(self):
        if not self._in_block:
            raise RuntimeError("Preprocessor.inputs() only valid inside block()")
        return read_file(self._reader)

    def outputs(self, *outs):
        if not self._in_block:
            raise RuntimeError("Preprocessor.outputs() only valid inside block()")
        self._outs = list(outs)

    def __call__(self):
        class _Transformed:
            def __init__(self, base, vars_):
                self._base = base
                self.vars = vars_

            def __getattr__(self, item):  # start/reset/decorate_* passthrough
                return getattr(self._base, item)

        return _Transformed(self._reader, self._outs)
