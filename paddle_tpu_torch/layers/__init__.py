"""Layer library (reference: python/paddle/fluid/layers/__init__.py).

The port's layer functions so far: nn (``beam_search`` and
``beam_search_decode`` among them), io (``data`` and the layers that
need no reader runtime), metric_op, ops, tensor, control_flow (``While``,
``ConditionalBlock``, ``Switch``, ``IfElse``, ``StaticRNN``,
``DynamicRNN``, the comparisons, the tensor arrays and the LoD rank
table), the learning-rate schedules, sequence (the ``sequence_*``,
``dynamic_lstm``/``lstmp``/``gru`` and unit layers) and detection (SSD's
``prior_box``, ``multi_box_head``, ``ssd_loss``, ``detection_output``,
the RPN layers and ``detection_map``), pipeline (``Pipeline``, stages
run in sequence on one device) and device (``get_places``).
"""
from . import nn
from . import io
from . import device
from .device import get_places  # noqa: F401
from . import metric_op
from . import ops
from . import tensor
from . import control_flow
from . import learning_rate_scheduler
from . import sequence as sequence_mod
from . import detection
from . import pipeline as pipeline_mod

from .nn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .pipeline import Pipeline  # noqa: F401

__all__ = (
    nn.__all__
    + io.__all__
    + metric_op.__all__
    + ops.__all__
    + tensor.__all__
    + control_flow.__all__
    + learning_rate_scheduler.__all__
    + sequence_mod.__all__
    + detection.__all__
    + pipeline_mod.__all__
)
