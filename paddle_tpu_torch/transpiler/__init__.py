"""Program transpilers of the port (see :mod:`.inference_transpiler`)."""
from .inference_transpiler import InferenceTranspiler  # noqa: F401

__all__ = ["InferenceTranspiler"]
