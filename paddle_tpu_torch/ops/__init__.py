"""Op rules (the port's counterpart of the JAX package's ``paddle_tpu/ops``).

Importing this package registers the PyTorch rule of every op the port
runs so far: the ops of the Transformer's training and startup
Programs.  Each rule is translated from the JAX package's rule of the
same name; an op without a rule raises ``NotImplementedError`` naming
it when the Executor reaches it.
"""
from . import tensor_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import attention_ops  # noqa: F401
