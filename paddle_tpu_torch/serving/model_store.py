"""Model store: load / version / warm inference models for serving.

Counterpart of ``paddle_tpu/serving/model_store.py``.  One
:class:`LoadedModel` is an immutable, self-contained executable view of
a saved inference model — its own ``Scope`` + ``Executor`` (Program
backend) or the loaded ``torch.export`` graph (AOT backend,
``__aot_torch__``), its feed specs, and a ``predict_batch`` entry point
— so hot swap is a pointer flip: the engine loads+warms the new version
while the old one keeps serving, then switches.

All artifact reads go through ``paddle_tpu_torch.io``'s resilience-routed
helpers (``resilience.fs_read_bytes`` + retry), so a flaky model mount
during a (re)load retries with backoff instead of killing the engine,
and ``paddle_tpu_torch.testing.faults`` can inject flaky reads at exact
paths to test every recovery branch.

Both backends run on the store's device (``place=None``: the card,
raising without one) under ``torch.no_grad()``, so serving keeps no
autograd state, and hand back numpy arrays (a device-to-host copy of
every fetch).  ``predict_batch`` is only ever called at the engine's
warmed bucket sizes, so the shapes a live request sees were all run at
warm-up.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from .. import io as io_mod
from .. import observability as _obs
from ..core import np_dtype, resolve_device
from ..executor import Executor, Scope, scope_guard
from .errors import ServingError

__all__ = ["LoadedModel", "ModelStore"]


class LoadedModel:
    """An executable model version.

    ``feed_specs``: ``{name: (shape, dtype)}`` where ``shape`` has
    ``None`` at the (leading) batch dim and static ints elsewhere;
    ``predict_batch(feed) -> [np.ndarray per fetch]`` runs one batch.
    """

    def __init__(self, kind, dirname, version, predict_batch, feed_names,
                 fetch_names, feed_specs):
        self.kind = kind
        self.dirname = dirname
        self.version = version
        self.predict_batch = predict_batch
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.feed_specs = dict(feed_specs)
        self.warmed_buckets = []
        # per-fetch: does the output carry the batch dim?  Ground truth
        # observed during warmup (leading dim tracks the bucket size
        # across >=2 distinct buckets); None = not established, the
        # engine falls back to a shape heuristic when slicing
        self.batched_fetch = None
        self._fetch_lead_dims = []
        self._closed = False

    def zeros_feed(self, batch):
        """A syntactically valid all-zeros feed at ``batch`` rows — the
        warm-up payload that runs one bucket."""
        feed = {}
        for name in self.feed_names:
            shape, dtype = self.feed_specs[name]
            if any(d is None for d in shape[1:]):
                raise ServingError(
                    "feed %r has dynamic non-batch dims %s; pass "
                    "feed_shapes={%r: full_shape} to the engine"
                    % (name, shape, name))
            feed[name] = np.zeros((batch,) + tuple(shape[1:]), dtype)
        return feed

    def warmup(self, buckets):
        """Run every bucket size up front so no live request pays a first
        run (kernel build, allocator growth).  Two runs per bucket, as
        the JAX package's warm-up compiles and then binds its fast
        path."""
        for b in sorted(set(int(x) for x in buckets)):
            if b in self.warmed_buckets:
                continue
            feed = self.zeros_feed(b)
            with _obs.timed("serving.warmup", bucket=b, model=self.kind):
                outs = self.predict_batch(feed)
                self.predict_batch(feed)
            self.warmed_buckets.append(b)
            self._fetch_lead_dims.append([
                np.shape(o)[0] if np.ndim(o) >= 1 else None for o in outs])
        # a fetch is batched iff its leading dim tracked the bucket size;
        # a single-bucket ladder can't disambiguate a coincidental match,
        # so the verdict needs >=2 distinct warmed buckets
        if len(self.warmed_buckets) >= 2:
            n_fetch = min(len(d) for d in self._fetch_lead_dims)
            self.batched_fetch = [
                all(dims[i] == b for b, dims in zip(self.warmed_buckets,
                                                    self._fetch_lead_dims))
                for i in range(n_fetch)
            ]
        return self

    def close(self):
        self._closed = True
        self.predict_batch = _closed_predict

    @property
    def closed(self):
        return self._closed


def _closed_predict(feed):
    raise ServingError("model version has been swapped out and closed")


def _program_specs(program, feed_names, feed_shapes):
    specs = {}
    blk = program.global_block()
    for name in feed_names:
        override = (feed_shapes or {}).get(name)
        shape = list(override if override is not None else blk.var(name).shape)
        if shape and int(shape[0]) in (-1, 0):
            shape[0] = None
        shape = tuple(None if isinstance(d, int) and d < 0 else d
                      for d in shape)
        specs[name] = (shape, np.dtype(np_dtype(blk.var(name).dtype)))
    return specs


def _aot_specs(dirname, feed_shapes):
    """Feed specs straight from ``__aot_torch_meta__`` (resilience-routed
    read): the symbolic batch dim comes back as None."""
    meta = io_mod._read_aot_meta(dirname)
    specs = {}
    for name, dims, dt in zip(meta["feed_names"], meta["feed_shapes"],
                              meta["feed_dtypes"]):
        override = (feed_shapes or {}).get(name)
        if override is not None:
            shape = tuple([None] + [int(d) for d in override[1:]])
        else:
            shape = tuple(int(d) if str(d).lstrip("-").isdigit() else None
                          for d in dims)
        specs[name] = (shape, np.dtype(dt))
    return specs


class ModelStore:
    """Loads model versions and hands out :class:`LoadedModel` handles.

    ``backend``: "aot" (require the ``__aot_torch__`` artifact),
    "program" (rebuild from ``__model__`` + params), or "auto" (AOT when
    the artifact exists).  Versions are monotonically numbered per store
    — the engine reports the active one in its health state.  ``place``
    (a Place, device string or ``torch.device``; None: the card) is
    where every version runs.  ``block_rows`` (the engine passes
    ``SERVING_BLOCK_ROWS``) makes the Program backend run each ``mul`` in
    blocks of that many rows, as one batched product, so that a
    request's rows come out with the same bits at every bucket
    (``Executor.block_rows``); the AOT graph was exported with the same
    blocks, so the two backends agree bit for bit.
    """

    def __init__(self, place=None, feed_shapes=None, block_rows=None):
        self.place = place
        self.device = resolve_device(place)
        self.feed_shapes = feed_shapes
        self.block_rows = block_rows
        self._version = 0
        self._lock = threading.Lock()

    def _next_version(self):
        with self._lock:
            self._version += 1
            return self._version

    def load(self, dirname, backend="auto"):
        if backend not in ("auto", "aot", "program"):
            raise ValueError("backend must be auto|aot|program, got %r"
                             % backend)
        has_aot = os.path.exists(os.path.join(dirname, io_mod.AOT_FILE))
        if backend == "aot" and not has_aot:
            if os.path.exists(os.path.join(dirname, "__aot__")):
                raise ServingError(
                    "%r holds only __aot__, the JAX package's jax.export "
                    "artifact, which this package does not load; save "
                    "with paddle_tpu_torch's save_inference_model(..., "
                    "aot=True) for its %s, or use backend='program'"
                    % (dirname, io_mod.AOT_FILE))
            raise ServingError(
                "no %s artifact in %r (save with aot=True, or use "
                "backend='program')" % (io_mod.AOT_FILE, dirname))
        use_aot = has_aot if backend == "auto" else (backend == "aot")
        version = self._next_version()
        with _obs.timed("serving.model_load", dirname=dirname,
                        backend="aot" if use_aot else "program"):
            model = (self._load_aot if use_aot else self._load_program)(
                dirname, version)
        _obs.inc("serving.model_loads")
        return model

    def _load_aot(self, dirname, version):
        predict, feed_names, fetch_names = io_mod.load_aot_inference_model(
            dirname, device=self.device)
        return LoadedModel("aot", dirname, version, predict, feed_names,
                           fetch_names, _aot_specs(dirname, self.feed_shapes))

    def _load_program(self, dirname, version):
        exe = Executor(device=self.device)
        exe.block_rows = self.block_rows
        scope = Scope()
        with scope_guard(scope):
            program, feed_names, fetch_vars = io_mod.load_inference_model(
                dirname, exe)
        fetch_names = [v.name for v in fetch_vars]
        specs = _program_specs(program, feed_names, self.feed_shapes)

        def predict_batch(feed):
            with torch.no_grad():
                outs = exe.run(program, feed=feed, fetch_list=fetch_vars,
                               scope=scope, return_numpy=True)
            return [np.asarray(o) for o in outs]

        model = LoadedModel("program", dirname, version, predict_batch,
                            feed_names, fetch_names, specs)
        # keep the executor/scope alive with (and droppable via) the model
        model._exe, model._scope = exe, scope

        def close(_orig=model.close):
            _orig()
            scope.drop()
            # the version's graphs and their pool go now, not when the
            # collector finds this model: a rolling swap loads the next
            # version beside it
            exe._drop_graphs()

        model.close = close
        return model
