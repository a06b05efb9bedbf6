"""Program transpilers of the port (see :mod:`.inference_transpiler` and
:mod:`.memory_optimization_transpiler`)."""
from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .memory_optimization_transpiler import (  # noqa: F401
    memory_optimize, release_memory)

__all__ = ["InferenceTranspiler", "memory_optimize", "release_memory"]
