"""Testing utilities: deterministic fault injection for the resilience
layer (``paddle_tpu_torch.testing.faults``)."""
from . import faults  # noqa: F401
