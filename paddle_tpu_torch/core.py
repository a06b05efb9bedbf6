"""Device resolution for the port.

The JAX package selects a backend through ``Place`` objects; the port's
entry points take a ``device`` instead and resolve it here.  The port
runs on the card: ``device=None`` means ``cuda``, and when no GPU is
present that is an error — an entry point never carries on quietly on
the CPU.  Callers that want the CPU (the tests) ask for it by name.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` (None, a string or a ``torch.device``) as a concrete
    ``torch.device``.  None resolves to ``cuda``; a CUDA device raises
    ``RuntimeError`` when ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("device must be 'cuda' or 'cpu', got %r" % (device,))
    return dev
