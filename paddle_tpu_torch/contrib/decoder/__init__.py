"""Decoder API (reference: python/paddle/fluid/contrib/decoder/)."""
from .beam_search_decoder import (  # noqa: F401
    BeamSearchDecoder,
    InitState,
    StateCell,
    TrainingDecoder,
)

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]
