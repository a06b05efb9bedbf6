"""Layer library (reference: python/paddle/fluid/layers/__init__.py).

The port's layer functions so far: nn (``beam_search`` and
``beam_search_decode`` among them), io (``data`` and the layers that
need no reader runtime), metric_op, ops, tensor, control_flow (``While``,
``ConditionalBlock``, ``Switch``, ``IfElse``, the comparisons and the
tensor arrays) and the learning-rate schedules.  ``StaticRNN``,
``DynamicRNN``, sequences, detection and the pipeline are not ported
yet.
"""
from . import nn
from . import io
from . import metric_op
from . import ops
from . import tensor
from . import control_flow
from . import learning_rate_scheduler

from .nn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403

__all__ = (
    nn.__all__
    + io.__all__
    + metric_op.__all__
    + ops.__all__
    + tensor.__all__
    + control_flow.__all__
    + learning_rate_scheduler.__all__
)
