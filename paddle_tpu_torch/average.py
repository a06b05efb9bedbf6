"""WeightedAverage — running weighted mean kept entirely host-side
(reference surface: python/paddle/fluid/average.py; it never touches the
Program).  The port's copy of the JAX package's ``average.py``: ``add``
also takes what ``Executor.run`` fetches (a ``LazyFetch`` or a tensor),
brought to the host first."""
from __future__ import annotations

import numpy as np

from .metrics import _host

__all__ = ["WeightedAverage"]


class WeightedAverage:
    """Accumulate (value, weight) pairs; ``eval()`` returns the weighted
    mean Σ(vᵢ·wᵢ) / Σwᵢ.  Array values contribute their mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._weighted_sum = 0.0
        self._total_weight = 0.0
        self._count = 0

    def add(self, value, weight):
        value, weight = _host(value), _host(weight)
        if isinstance(weight, np.ndarray) and weight.size == 1:
            weight = weight.reshape(()).item()  # fetched size-1 tensors
        if not isinstance(weight, (int, float, np.integer, np.floating)):
            raise ValueError("weight must be a number, got %r" % type(weight))
        if isinstance(value, (str, bytes)):
            raise ValueError("value must be a number or numeric array, got a string")
        try:
            scalar = float(np.mean(np.asarray(value, dtype=np.float64)))
        except (TypeError, ValueError):
            raise ValueError("value must be a number or numeric array, got %r"
                             % type(value))
        self._weighted_sum += scalar * float(weight)
        self._total_weight += float(weight)
        self._count += 1

    def eval(self):
        if self._count == 0:
            raise ValueError("WeightedAverage.eval() called before any add()")
        if self._total_weight == 0.0:
            raise ValueError("WeightedAverage weights sum to zero")
        return self._weighted_sum / self._total_weight
