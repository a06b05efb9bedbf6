"""Layer library (reference: python/paddle/fluid/layers/__init__.py).

The port's layer functions so far: nn, io (``data``), ops, tensor,
control_flow's ``equal`` and the learning-rate schedules.  The
sub-block control flow, sequences, detection and the pipeline are not
ported yet.
"""
from . import nn
from . import io
from . import ops
from . import tensor
from . import control_flow
from . import learning_rate_scheduler

from .nn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403

__all__ = (
    nn.__all__
    + io.__all__
    + ops.__all__
    + tensor.__all__
    + control_flow.__all__
    + learning_rate_scheduler.__all__
)
