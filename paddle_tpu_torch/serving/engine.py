"""InferenceEngine: the serving entry point of the port.

Counterpart of ``paddle_tpu/serving/engine.py``.  This slice serves
autoregressive generation: construct the engine with ``decode_model=``
(see ``models.transformer.build_decode_model``) and call
``generate()``/``generate_async()`` — continuous batching over a paged
KV cache on the card (decode_scheduler.py, kv_cache.py).  The predict
path over a saved inference model (``model_dir``) is not ported yet and
raises ``NotImplementedError``.

The engine runs on the card unless asked otherwise: ``device=None``
resolves to ``cuda`` and raises when there is no GPU.  The decode model
must live on the engine's device.
"""
from __future__ import annotations

import copy

from ..core import resolve_device
from .decode_scheduler import DecodeConfig, DecodeScheduler
from .errors import ServingClosed

__all__ = ["InferenceEngine"]


class InferenceEngine:
    """Serve a decode model with continuous batching.

    Parameters
    ----------
    model_dir: a saved inference model for ``predict`` — not ported yet;
        anything but None raises ``NotImplementedError``.
    decode_model: a :class:`~.decode_scheduler.DecodeModel` (required).
    decode_config: :class:`~.decode_scheduler.DecodeConfig` for the
        decode runtime (slots, KV paging geometry, prefill buckets,
        chunked prefill via ``prefill_chunk_tokens``).
    default_deadline_ms: deadline for requests that don't carry their
        own, when no ``decode_config`` is given.
    warmup: run every decode-runtime width once at construction.
    autostart: start the decode worker immediately; tests pass False to
        exercise queue semantics deterministically, then call
        :meth:`start`.
    device: where the engine serves (None: the card, raising without
        one); must match the decode model's device.
    """

    def __init__(self, model_dir=None, decode_model=None, decode_config=None,
                 default_deadline_ms=None, warmup=True, autostart=True,
                 device=None):
        if model_dir is not None:
            raise NotImplementedError(
                "InferenceEngine(model_dir=...) (the predict path) is not "
                "ported to paddle_tpu_torch yet; serve a decode_model")
        if decode_model is None:
            raise ValueError("InferenceEngine needs a decode_model")
        self.device = resolve_device(device)
        if decode_model.device != self.device:
            raise ValueError(
                "decode_model lives on %s but the engine serves on %s; "
                "build it with build_decode_model(..., device=%r)"
                % (decode_model.device, self.device, str(self.device)))
        # shallow-copy: the engine's warmup override must not mutate a
        # caller-owned config reused for other engines
        cfg = (copy.copy(decode_config) if decode_config is not None
               else DecodeConfig(default_deadline_ms=default_deadline_ms))
        if not warmup:
            cfg.warmup = False
        self._decoder = DecodeScheduler(decode_model, cfg, autostart=False)
        self._state = "ready"
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Start (or revive a dead) decode worker."""
        if not self._decoder.alive:
            self._decoder.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Stop serving.  ``drain=True`` answers everything already
        admitted first; either way new requests are rejected with
        ``ServingClosed`` from the moment the stop begins."""
        if self._state == "stopped":
            return
        self._state = "stopped"
        self._decoder.stop(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- health --------------------------------------------------------------
    @property
    def state(self):
        """"ready" | "stopped"."""
        return self._state

    def ready(self):
        return self._state == "ready" and self._decoder.alive

    def health(self):
        return {
            "state": self.state,
            "ready": self.ready(),
            "device": str(self.device),
            "worker_alive": self._decoder.alive,
            "decode": self._decoder.stats(),
        }

    # -- request admission ---------------------------------------------------
    def generate_async(self, prompt, max_new_tokens=None, deadline_ms=None,
                       priority=None, temperature=None, seed=None):
        """Admit one generation prompt (1-D token ids); returns its
        :class:`~.decode_scheduler.GenerateRequest` future whose
        ``result(timeout)`` is the generated int32 token ids.  Raises
        ``ServingClosed`` when stopped, ``ServingQueueFull`` under
        backpressure, ``ServingOverloaded`` when the deadline is already
        unmeetable, and ``ServingError`` for malformed requests."""
        if self._state == "stopped":
            raise ServingClosed("engine is stopped")
        return self._decoder.submit(prompt, max_new_tokens=max_new_tokens,
                                    deadline_ms=deadline_ms,
                                    priority=priority,
                                    temperature=temperature, seed=seed)

    def generate(self, prompt, max_new_tokens=None, deadline_ms=None,
                 priority=None, timeout=None, temperature=None, seed=None):
        """Synchronous generate: int32 token ids (greedy by default;
        ``temperature``/``seed`` for sampling; stops at the decode
        model's ``eos_id`` or ``max_new_tokens``)."""
        return self.generate_async(
            prompt, max_new_tokens=max_new_tokens, deadline_ms=deadline_ms,
            priority=priority, temperature=temperature,
            seed=seed).result(timeout=timeout)
