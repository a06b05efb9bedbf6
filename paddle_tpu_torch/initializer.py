"""Parameter initializers (reference: python/paddle/fluid/initializer.py).

The port's copy of the JAX package's ``paddle_tpu/initializer.py``.  Each
initializer appends an init op (fill_constant, uniform_random, ...) to
the startup program; the port's Executor runs those ops with PyTorch on
the card, drawing from a seeded ``torch.Generator``.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "Initializer",
    "Constant",
    "Uniform",
    "Normal",
    "TruncatedNormal",
    "Xavier",
    "MSRA",
    "Bilinear",
    "ConstantInitializer",
    "UniformInitializer",
    "NormalInitializer",
    "TruncatedNormalInitializer",
    "XavierInitializer",
    "MSRAInitializer",
    "BilinearInitializer",
    "NumpyArrayInitializer",
    "force_init_on_cpu",
    "init_on_cpu",
]

_force_init_on_cpu_ = False


def force_init_on_cpu():
    return _force_init_on_cpu_


class init_on_cpu:
    """No-op context kept for API parity — XLA decides placement."""

    def __enter__(self):
        global _force_init_on_cpu_
        self._old = _force_init_on_cpu_
        _force_init_on_cpu_ = True
        return self

    def __exit__(self, *a):
        global _force_init_on_cpu_
        _force_init_on_cpu_ = self._old
        return False


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fans(var):
        shape = var.shape
        if len(shape) == 0:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        # conv kernels [out_c, in_c, k...] (reference initializer.py:134)
        receptive = int(np.prod(shape[2:]))
        return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = float(value)

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": self.value},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = float(low), float(high), seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "min": self.low, "max": self.high, "seed": self.seed},
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std, self.seed = float(loc), float(scale), seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "mean": self.mean, "std": self.std, "seed": self.seed},
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std, self.seed = float(loc), float(scale), seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "mean": self.mean, "std": self.std, "seed": self.seed},
        )


class XavierInitializer(Initializer):
    """Glorot init (reference initializer.py:327)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He/Kaiming init (reference initializer.py:415)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / fi)
        return NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """For upsampling conv_transpose kernels (reference initializer.py:497)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("bilinear init needs a 4-D conv kernel")
        weight = np.zeros(shape, dtype="float32")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        size = int(np.prod(shape))
        for i in range(size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            val = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
            weight.flat[i] = val
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var]},
            attrs={"shape": list(shape), "dtype": var.dtype, "values": weight},
        )


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var]},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype, "values": self.value},
        )


# short aliases, as in the reference
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
