"""Program transpilers of the port: the distribute transpiler with its
parameter-server runtime (:mod:`.distribute_transpiler`,
:mod:`.pserver_runtime`, :mod:`.ps_dispatcher`, :mod:`.discovery`),
:mod:`.inference_transpiler` and :mod:`.memory_optimization_transpiler`."""
from .distribute_transpiler import (  # noqa: F401
    DistributeTranspiler, DistributeTranspilerConfig)
from .ps_dispatcher import HashName, RoundRobin  # noqa: F401
from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .memory_optimization_transpiler import (  # noqa: F401
    memory_optimize, release_memory)

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig", "HashName",
           "RoundRobin", "InferenceTranspiler", "memory_optimize",
           "release_memory"]
