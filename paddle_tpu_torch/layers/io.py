"""Data-side layers (reference: python/paddle/fluid/layers/io.py).

Copies of the JAX package's layers: ``data`` declares a feed slot,
``py_reader`` creates a host-side prefetching pipeline bound to feed
slots (the Executor pulls a batch from each started reader when a run
gets no feed; an exhausted reader raises ``core.EOFException``),
``read_file`` hands out a reader's slots, ``shuffle``/``batch`` are the
reader decorators and ``double_buffer`` the identity (the device
prefetch pipeline, ``reader.device_prefetch``, is the port's double
buffer), ``random_data_generator`` is an in-graph uniform source,
``load`` builds the load op (its rule reads the ``.npy`` file on the
host at every run, so a Program that holds one is never bound) and
``Preprocessor`` puts a reader's transform ops in the main graph.  The
recordio readers (``open_recordio_file``, ``open_files``) wait for the
recordio files (ROADMAP A12) and raise ``NotImplementedError`` naming
it.
"""
from __future__ import annotations

import weakref

from ..framework import default_main_program
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


_PROGRAM_READERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def program_readers(program, create=False):
    """py_readers bound to ``program`` (empty list if none)."""
    if create and program not in _PROGRAM_READERS:
        _PROGRAM_READERS[program] = []
    return _PROGRAM_READERS.get(program, [])


class _PyReader:
    """Host-side prefetch queue bound to feed slots.  ``decorate_paddle_reader``
    / ``start`` / ``reset`` mirror the reference py_reader surface; iteration
    happens in Executor.run via the feeder hook."""

    def __init__(self, capacity, shapes, dtypes, lod_levels, names):
        import collections
        import queue

        self.capacity = capacity
        self.shapes = shapes
        self.dtypes = dtypes
        self.lod_levels = lod_levels
        self.names = names
        self.queue = queue.Queue(maxsize=capacity)
        self._reader = None
        self._thread = None
        self._stop = False
        self._pushback = collections.deque()  # items returned by the executor
        self.vars = None

    def decorate_paddle_reader(self, reader):
        self._reader = reader

    decorate_sample_list_generator = decorate_paddle_reader
    decorate_batch_generator = decorate_paddle_reader

    def start(self):
        import threading

        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "py_reader already started — call reset() before start()ing "
                "again (two producers on one queue desynchronize epochs)")
        self._stop = False
        # the worker closes over ITS queue: after reset() swaps self.queue,
        # a producer that outlived the join timeout can only touch the old
        # (discarded) queue, never poison the new epoch with its sentinel
        q = self.queue

        def worker():
            try:
                for item in self._reader():
                    if self._stop:
                        return
                    q.put(item)
            finally:
                q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop = True
        if self._thread is not None:
            while not self.queue.empty():
                self.queue.get_nowait()
            self._thread.join(timeout=1.0)
            self._thread = None  # next() before the next start() raises EOF
        self._pushback.clear()
        self.queue = __import__("queue").Queue(maxsize=self.capacity)

    def next(self):
        from ..core import EOFException

        if self._pushback:
            return self._pushback.popleft()
        if self._thread is None:
            raise EOFException(
                "py_reader is not started — call start() (again after reset())")
        item = self.queue.get()
        if item is None:
            # leave the sentinel in place: a further next() must raise
            # again instead of blocking on an empty queue forever
            self.queue.put(None)
            raise EOFException("py_reader pipeline exhausted")
        return item

    def feed_dict(self):
        """One prefetched item as a feed dict over this reader's slots."""
        item = self.next()
        if len(item) != len(self.names):
            raise ValueError(
                "reader produced %d slots, expected %d (%s)"
                % (len(item), len(self.names), self.names))
        return dict(zip(self.names, item))


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None, use_double_buffer=True):
    names = []
    vars_ = []
    lod_levels = lod_levels or [0] * len(shapes)
    for i, (shape, dtype, ll) in enumerate(zip(shapes, dtypes, lod_levels)):
        v = data(
            name=(name or "py_reader") + "_slot%d" % i,
            shape=list(shape)[1:],
            dtype=dtype,
            lod_level=ll,
        )
        names.append(v.name)
        vars_.append(v)
    r = _PyReader(capacity, shapes, dtypes, lod_levels, names)
    r.vars = vars_
    # registered in a weak side table, NOT as a program attribute: the
    # reader holds queues/threads that would break Program.clone()'s
    # deepcopy; clones intentionally start with no readers
    program_readers(default_main_program(), create=True).append(r)
    return r


def shuffle(reader, buffer_size):
    from ..reader import decorator

    return decorator.shuffle(reader, buffer_size)


def batch(reader, batch_size):
    from .. import reader as reader_mod

    return reader_mod.batch(reader, batch_size)


def double_buffer(reader, place=None, name=None):
    return reader


def open_recordio_file(filename, shapes, lod_levels, dtypes, pass_num=1,
                       for_parallel=True):
    raise NotImplementedError(
        "layers.open_recordio_file is not ported to paddle_tpu_torch yet: "
        "it waits for the recordio files (ROADMAP A12)")


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=1,
               buffer_size=None, pass_num=1):
    raise NotImplementedError(
        "layers.open_files is not ported to paddle_tpu_torch yet: it waits "
        "for the recordio files (ROADMAP A12)")


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
