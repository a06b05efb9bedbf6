"""Models of the port: :mod:`.mnist` (LeNet), :mod:`.resnet` (ResNet-50
and the CIFAR-10 ResNets) and :mod:`.transformer`."""
from . import mnist  # noqa: F401
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
