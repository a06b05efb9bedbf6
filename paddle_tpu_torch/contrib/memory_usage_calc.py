"""Program memory footprint (reference:
python/paddle/fluid/contrib/memory_usage_calc.py).

The JAX package reads XLA's ``memory_analysis()`` of the compiled step.
The port has no executable to ask, so it measures: the step runs once
(``profiler.compile_step``, a counted eager run on throwaway state of
its own) and the count gives the bytes of its inputs and outputs and,
on the card, the allocator's peak over the run
(``observability.xla_stats``).  :func:`memory_usage` keeps the
historical ``(low, high, unit)`` contract:

- measured (the default on the card): ``low`` = the step's peak (inputs
  + outputs + temporaries), ``high`` = that plus 5% for the allocator's
  rounding and fragmentation.  There is no generated code to add
  (``code_bytes`` is 0).  A measured run that fails raises.
- estimate (the default on the CPU, which has no allocator to read;
  ``precise=False`` anywhere): the raw var-size sum banded to
  [0.5x, 1.2x].

:func:`memory_analysis` returns the full byte breakdown.
"""
from __future__ import annotations

import numpy as np

from ..core import np_dtype, resolve_device

__all__ = ["memory_usage", "memory_analysis"]

DTYPE_SIZES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
               "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
               "bool": 1}


def _synthesize_inputs(program, batch_size):
    """Zero-filled feed and state dicts matching the program's declared
    shapes, the batch (-1) dims filled with ``batch_size``."""
    feeds, state = {}, {}
    for var in program.list_vars():
        if var.shape is None:
            continue
        shape = tuple(int(batch_size) if (s is None or s < 0) else int(s)
                      for s in var.shape)
        try:
            dtype = np_dtype(var.dtype)
        except Exception:
            continue
        if var.persistable:
            state[var.name] = np.zeros(shape, dtype)
        elif getattr(var, "is_data", False):
            feeds[var.name] = np.zeros(shape, dtype)
    return feeds, state


def _graph_sinks(program):
    """Non-persistable vars the block produces but never consumes — the
    natural fetch targets of a fetch-less inference program."""
    block = program.global_block()
    produced, consumed = set(), set()
    for op in block.ops:
        for outs in op.outputs.values():
            produced.update(outs)
        for ins in op.inputs.values():
            consumed.update(ins)
    sinks = []
    for n in sorted(produced - consumed):
        if block.has_var(n) and not block.var(n).persistable:
            sinks.append(n)
    return sinks


def memory_analysis(program, batch_size, device=None):
    """Run the step once on ``device`` (None: the card) from zero feeds
    and state and return its byte accounting: ``{"peak_hbm_bytes",
    "arg_bytes", "output_bytes", "temp_bytes", "code_bytes", "flops",
    "bytes_accessed"}`` (``temp_bytes`` 0 on the CPU, ``code_bytes``
    always 0).  Raises when the step fails or cannot be counted."""
    if batch_size <= 0:
        raise ValueError("batch_size must be positive, got %r" % (batch_size,))
    from .. import profiler

    feeds, state = _synthesize_inputs(program, batch_size)
    st = profiler.compile_step(program, feeds, state=state,
                               fetch_list=_graph_sinks(program),
                               device=device)
    return {
        "peak_hbm_bytes": st.peak_hbm_bytes,
        "arg_bytes": st.arg_bytes,
        "output_bytes": st.out_bytes,
        "temp_bytes": st.temp_bytes,
        "code_bytes": st.code_bytes,
        "flops": st.flops,
        "bytes_accessed": st.bytes_accessed,
    }


def _estimate(program, batch_size):
    total = 0.0
    for var in program.list_vars():
        if var.shape is None:
            continue
        cnt = 1
        for s in var.shape:
            cnt *= batch_size if (s is None or s < 0) else s
        try:
            width = DTYPE_SIZES.get(str(var.dtype),
                                    np.dtype(np_dtype(var.dtype)).itemsize)
        except TypeError:
            width = 4
        total += cnt * width
    return total * 0.5, total * 1.2


def memory_usage(program, batch_size, precise=None, device=None):
    """(low, high, unit) of the program's step footprint on ``device`` (a
    place or a device; None: the card, raising without one).

    ``precise=None`` measures on the card and estimates on the CPU;
    ``True`` measures (on the CPU without temporaries) and ``False``
    estimates.  A measurement that fails raises."""
    if batch_size <= 0:
        raise ValueError("batch_size must be positive, got %r" % (batch_size,))
    dev = resolve_device(device)
    if precise is None:
        precise = dev.type != "cpu"
    if precise:
        stats = memory_analysis(program, batch_size, device=dev)
        low = float(stats["peak_hbm_bytes"])
        high = (low + float(stats["code_bytes"])) * 1.05
    else:
        low, high = _estimate(program, batch_size)
    for unit, factor in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10),
                         ("B", 1)):
        if high >= factor or factor == 1:
            return low / factor, high / factor, unit
