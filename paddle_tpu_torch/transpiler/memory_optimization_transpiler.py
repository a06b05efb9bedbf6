"""memory_optimize / release_memory (reference:
python/paddle/fluid/transpiler/memory_optimization_transpiler.py).

The reference rewrites a Program so that variables reuse each other's
buffers (liveness-based in-place sharing).  On the card the port leaves
the Program as it is, as the JAX package does: PyTorch's caching
allocator hands a freed block to the next tensor that fits, every CUDA
graph an Executor captures shares one private pool (a later capture
reuses what the earlier ones freed), and a captured step updates the
persistables it writes in place, in their state buffers.  The functions
exist for API parity and, with ``print_log``, say what reuses memory.
"""
from __future__ import annotations

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    """Return ``input_program`` unchanged (see the module docstring)."""
    if print_log:
        print("memory_optimize: the Program is left as it is; on the card "
              "PyTorch's caching allocator reuses freed blocks, the "
              "Executor's CUDA graphs share one private pool, and a "
              "captured step updates its state buffers in place.")
    return input_program


def release_memory(input_program, skip_opt_set=None):
    """Return ``input_program`` unchanged."""
    return input_program
