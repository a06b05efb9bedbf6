"""Model save/load + inference model (reference: python/paddle/fluid/io.py).

Counterpart of ``paddle_tpu/io.py``, with its on-disk format byte for
byte: ``filename=None`` → one ``<var>.npy`` file per variable;
``filename=...`` → one combined ``.npz``; an inference model is the
pruned Program as ``Program.to_dict()`` JSON (``__model__``) beside its
parameters.  A directory saved by either package loads in the other.
Every file goes through ``resilience``'s fault-injectable read/write
choke point with transient-error retry.

Parameters live in the Scope as tensors (or as numpy arrays just after a
load; ``Executor.run`` moves them to its device at first use); saving
copies them to the host.  Directories written by the original framework
(one binary LoDTensor file per variable, no ``.npy`` suffix) are not
read yet.

The AOT backend.  ``save_inference_model(..., aot=True)`` also writes a
``torch.export`` graph of the pruned Program with the weights in it
(``__aot_torch__``, saved by ``torch.export.save``) and its feed specs
(``__aot_torch_meta__``): the batch dimension is symbolic
(``torch.export.Dim``), so one artifact serves any batch size, and the
other dimensions are static.  :func:`load_aot_inference_model` loads it
with no Program rebuild; it needs ``import paddle_tpu_torch``, which
registers the flash forward operator the graph calls
(``torch.ops.paddle_tpu_torch.flash_fwd``), and no jax.  The artifact
runs on the device it was exported on, which the meta file records;
loading it on another device raises ``ServingError``.  The names are
the port's own: the JAX package's ``__aot__``/``__aot_meta__`` hold a
``jax.export`` StableHLO artifact, and neither package reads the
other's.
"""
from __future__ import annotations

import json
import os
from io import BytesIO

import numpy as np
import torch

from . import observability as _obs
from . import resilience
from .core import (canonical_dtype, f32_bf16_reduction, resolve_device,
                   torch_dtype)
from .executor import (SERVING_BLOCK_ROWS, LoweringContext, _as_tensor,
                       as_numpy, global_scope, interpret_ops)
from .framework import Parameter, Program, Variable, default_main_program
# registers torch.ops.paddle_tpu_torch.flash_fwd, which exported graphs call
from .parallel import flash_attention  # noqa: F401

# transient-FS retry for every param file read/write (shared model mounts
# hiccup; a clean retry beats losing a save)
IO_RETRY_POLICY = resilience.RetryPolicy(
    max_retries=2, base_delay=0.05, max_delay=0.5)

#: the port's AOT artifact and its feed specs (the JAX package's are
#: ``__aot__`` and ``__aot_meta__``)
AOT_FILE = "__aot_torch__"
AOT_META_FILE = "__aot_torch_meta__"

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
    "load_aot_inference_model",
    "get_inference_program",
    "read_artifact_bytes",
    "is_parameter",
    "is_persistable",
    "get_parameter_value",
    "get_parameter_value_by_name",
]


def is_parameter(var):
    return isinstance(var, Parameter)


def is_persistable(var):
    return bool(var.persistable)


def _var_bytes(scope, name):
    val = scope.vars.get(name)
    if val is None:
        raise KeyError("variable %r has no value in scope (run startup first?)" % name)
    return as_numpy(val)


def _write_npy(path, arr):
    """np.save through the resilience choke point: serialized in memory,
    written with fsync + transient-error retry (fault-injectable)."""
    buf = BytesIO()
    np.save(buf, np.asarray(arr))
    _write_artifact_bytes(path, buf.getvalue())


def _write_npz(path, arrays):
    buf = BytesIO()
    np.savez(buf, **arrays)
    _write_artifact_bytes(path, buf.getvalue())


def read_artifact_bytes(path):
    """Read a model-artifact file through the resilience choke point
    (``fs_read_bytes`` + transient-error retry).  Inference model loads
    (``__model__``, ``__aot_torch__``, ``__aot_torch_meta__``) share the
    parameter files' fault-injectable read path, so a flaky model mount
    retries instead of killing a serving engine's (re)load — and
    ``testing.faults.flaky_io`` can target exact artifacts in tests."""
    return resilience.call_with_retry(
        resilience.fs_read_bytes, path, policy=IO_RETRY_POLICY)


def _write_artifact_bytes(path, data):
    resilience.call_with_retry(
        resilience.fs_write_bytes, path, data, policy=IO_RETRY_POLICY)


def _read_np(path):
    """np.load (npy or npz) through the resilience choke point."""
    data = read_artifact_bytes(path)
    return np.load(BytesIO(data), allow_pickle=False)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None, filename=None):
    main_program = main_program or default_main_program()
    if vars is None:
        vars = list(filter(predicate, main_program.list_vars()))
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    with _obs.timed("io.save_vars", vars=len(vars)):
        if filename is None:
            for v in vars:
                _write_npy(os.path.join(dirname, v.name + ".npy"), _var_bytes(scope, v.name))
        else:
            if not filename.endswith(".npz"):
                filename += ".npz"  # np.savez appended it; keep the layout
            _write_npz(
                os.path.join(dirname, filename),
                {v.name: _var_bytes(scope, v.name) for v in vars},
            )


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None, filename=None):
    main_program = main_program or default_main_program()
    if vars is None:
        vars = list(filter(predicate, main_program.list_vars()))
    scope = global_scope()
    if filename is None:
        for v in vars:
            scope[v.name] = _read_np(os.path.join(dirname, v.name + ".npy"))
    else:
        data = _read_np(os.path.join(dirname, filename) + ("" if filename.endswith(".npz") else ".npz"))
        for v in vars:
            scope[v.name] = data[v.name]


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable, filename=filename)


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    return main_program.prune(target_vars)


def save_inference_model(
    dirname,
    feeded_var_names,
    target_vars,
    executor,
    main_program=None,
    model_filename=None,
    params_filename=None,
    export_for_deployment=True,
    aot=False,
    aot_feed_shapes=None,
    aot_platforms=None,
):
    """Write the pruned inference Program (``__model__``) and its
    persistables.  ``aot=True`` also writes a ``torch.export`` artifact
    (``__aot_torch__`` + ``__aot_torch_meta__``, see the module
    docstring) with the weights in it, exported on ``executor``'s device:
    a fresh process loads and predicts with NO Program rebuild.  The
    batch dim exports symbolically, so one artifact serves any batch
    size; other dims must be static (override with
    ``aot_feed_shapes={name: shape}``).  ``aot_platforms`` may name only
    that device's type: the artifact runs where it was exported.  Ragged
    (lod_level>=1) feeds are not AOT-exportable; serve those through
    ``load_inference_model``."""
    main_program = main_program or default_main_program()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    os.makedirs(dirname, exist_ok=True)
    inference_program = main_program.prune(target_vars)
    model = {
        "program": inference_program.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name if isinstance(v, Variable) else v for v in target_vars],
    }
    _write_artifact_bytes(
        os.path.join(dirname, model_filename or "__model__"),
        json.dumps(model).encode("utf-8"))
    params = [v for v in inference_program.list_vars() if is_persistable(v)]
    save_vars(executor, dirname, vars=params, filename=params_filename)
    if aot:
        dev = executor.device
        if aot_platforms is not None and tuple(aot_platforms) != (dev.type,):
            raise ValueError(
                "the port's AOT artifact runs on the device it is exported "
                "on (%s); aot_platforms=%r" % (dev.type, aot_platforms))
        _export_aot(
            dirname, inference_program, model["feed_names"],
            model["fetch_names"], aot_feed_shapes, dev)
    return model["fetch_names"]


class _InferenceModule(torch.nn.Module):
    """The pruned Program as a module for ``torch.export``: its state as
    buffers (``s0``, ``s1``, ... in sorted name order; Program names hold
    dots), its forward the op rules run in test mode over the feeds.  The
    pruned Program holds no backward op, and the export runs under
    ``torch.no_grad()``, so the forward calls ``interpret_ops`` itself
    rather than ``lower_block``: a grad-mode switch inside the traced
    function would cost the exporter a pass that splits the graph at it
    (about 40% of the trace on the CPU).  Each ``mul`` runs as the
    serving Program backend runs it, through the operator
    ``paddle_tpu_torch::blocked_mm`` (blocks of ``SERVING_BLOCK_ROWS``
    rows in one batched product), which the export keeps as one node
    over the symbolic batch, so both backends give a request the same
    bits at every bucket."""

    def __init__(self, program, feed_names, fetch_names, state, device):
        super().__init__()
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._state_names = sorted(state)
        self._device = device
        for i, name in enumerate(self._state_names):
            self.register_buffer("s%d" % i, state[name])

    def forward(self, *feeds):
        env = {n: getattr(self, "s%d" % i)
               for i, n in enumerate(self._state_names)}
        env.update(zip(self._feed_names, feeds))
        ctx = LoweringContext(self._program, env, self._device,
                              is_test=True, block_rows=SERVING_BLOCK_ROWS)
        interpret_ops(ctx, self._program.global_block().ops)
        return tuple(ctx.env[n] for n in self._fetch_names)


def _export_aot(dirname, inference_program, feed_names, fetch_names,
                feed_shapes, device):
    scope = global_scope()
    blk = inference_program.global_block()
    state = {
        v.name: _as_tensor(scope.vars[v.name], torch_dtype(v.dtype), device)
        for v in inference_program.list_vars()
        if is_persistable(v) and scope.vars.get(v.name) is not None
    }
    module = _InferenceModule(inference_program, feed_names, fetch_names,
                              state, device)
    batch = torch.export.Dim("batch", min=1)
    examples, dynamic, shapes, dtypes = [], [], [], []
    for name in feed_names:
        var = blk.var(name)
        shape = list((feed_shapes or {}).get(name) or var.shape)
        symbolic = bool(shape) and int(shape[0]) in (-1, 0)
        if symbolic:
            shape[0] = 2   # an example batch; exported as `batch`
        if any(int(s) <= 0 for s in shape):
            raise ValueError(
                "AOT export needs static non-batch dims for feed %r, got %s "
                "(pass aot_feed_shapes={%r: full_shape})"
                % (name, list(var.shape), name))
        examples.append(torch.zeros(shape, dtype=torch_dtype(var.dtype),
                                    device=device))
        dynamic.append({0: batch} if symbolic else None)
        shapes.append([("b" if symbolic and i == 0 else str(int(s)))
                       for i, s in enumerate(shape)])
        dtypes.append(canonical_dtype(var.dtype))
    with torch.no_grad():
        exported = torch.export.export(
            module, tuple(examples), dynamic_shapes={"feeds": tuple(dynamic)})
    buf = BytesIO()
    torch.export.save(exported, buf)
    _write_artifact_bytes(os.path.join(dirname, AOT_FILE), buf.getvalue())
    _write_artifact_bytes(os.path.join(dirname, AOT_META_FILE), json.dumps({
        "feed_names": list(feed_names),
        "feed_dtypes": dtypes,
        "feed_shapes": shapes,
        "fetch_names": list(fetch_names),
        "device": str(device),
        "torch_version": torch.__version__,
    }).encode("utf-8"))


def _read_aot_meta(dirname):
    """The AOT artifact's feed specs and device (``__aot_torch_meta__``,
    read through the resilience choke point)."""
    return json.loads(read_artifact_bytes(
        os.path.join(dirname, AOT_META_FILE)).decode("utf-8"))


def load_aot_inference_model(dirname, device=None):
    """Load an ``aot=True`` artifact WITHOUT rebuilding the Program:
    returns ``(predict, feed_names, fetch_names)`` where
    ``predict(feed_dict) -> [numpy array per fetch]`` runs the exported
    graph (weights in it; batch size free) on ``device`` (None: the card,
    raising without one), which must be the device the artifact was
    exported on (``ServingError`` otherwise)."""
    from .serving.errors import ServingError

    dev = resolve_device(device)
    meta = _read_aot_meta(dirname)
    if meta["device"] != str(dev):
        raise ServingError(
            "the AOT artifact in %r was exported on %s and runs only "
            "there, not on %s; export it again on %s, or serve the "
            "Program (backend='program')"
            % (dirname, meta["device"], dev, dev))
    exported = torch.export.load(BytesIO(
        read_artifact_bytes(os.path.join(dirname, AOT_FILE))))
    call = exported.module()
    feed_names = meta["feed_names"]
    dtypes = [torch_dtype(d) for d in meta["feed_dtypes"]]

    def predict(feed):
        args = [_as_tensor(feed[n], dt, dev)
                for n, dt in zip(feed_names, dtypes)]
        with torch.no_grad(), f32_bf16_reduction(dev):
            return [as_numpy(o) for o in call(*args)]

    return predict, feed_names, meta["fetch_names"]


def load_inference_model(dirname, executor, model_filename=None, params_filename=None):
    model = json.loads(
        read_artifact_bytes(
            os.path.join(dirname, model_filename or "__model__"))
        .decode("utf-8"))
    program = Program.from_dict(model["program"])
    params = [v for v in program.list_vars() if is_persistable(v)]
    load_vars(executor, dirname, vars=params, filename=params_filename)
    fetch_vars = [program.global_block().var(n) for n in model["fetch_names"]]
    return program, model["feed_names"], fetch_vars


def get_parameter_value(para, executor):
    if not is_parameter(para):
        raise TypeError("expected a Parameter")
    return as_numpy(global_scope()[para.name])


def get_parameter_value_by_name(name, executor, program=None):
    program = program or default_main_program()
    return get_parameter_value(program.global_block().var(name), executor)
