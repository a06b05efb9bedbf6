"""Transient-failure resilience for io and serving: retry policies, error
classification, and fault-injectable filesystem primitives.

Counterpart of ``paddle_tpu/resilience.py``, ported for what the port's
io (model and parameter files) and serving dispatch use::

    from paddle_tpu_torch import resilience

    @resilience.retry(resilience.RetryPolicy(max_retries=5))
    def flaky(): ...

    resilience.call_with_retry(np.load, path)          # default policy

Classification is explicit: programming errors (TypeError, KeyError, a
missing file) re-raise immediately; OS-level IO errors and transient
device errors back off exponentially with jitter and retry.

What is transient on the card.  The JAX package retries XLA status
codes (``RESOURCE_EXHAUSTED`` and friends); its counterpart here is
:func:`is_transient_cuda_error`:

- ``torch.cuda.OutOfMemoryError`` plays ``RESOURCE_EXHAUSTED``: the
  caching allocator could not serve one request, the context is intact,
  and the same call may succeed once other work frees memory.  It is
  transient.
- A kernel launch error (the ``RuntimeError`` that a kernel wrapper
  raises when its C entry returns a CUDA error,
  ``parallel/flash_attention.py:_raise_on``) is NOT transient: the same
  launch with the same shapes is refused again.
- Nor is any error after a device-side assert or an illegal address.
  Those errors are sticky: the CUDA context is lost, every later call
  on it fails, and a retry must not hide that.  An out-of-memory error
  whose message names such a fault is not retried either.

The ``fs_write_bytes`` / ``fs_read_bytes`` primitives are the single
choke point for model and parameter file IO, and ``_serve_fault`` the
one for a serving dispatch attempt: ``paddle_tpu_torch.testing.faults``
installs hooks on them (intermittent IOError, flaky, slow or poisoned
dispatches, a killed worker) so every recovery path is deterministically
testable without monkeypatching ``open`` globally.  Torn writes, NaN
feeds and checkpoint IO wait for the training runtime's port.
"""
from __future__ import annotations

import functools
import os
import random
import time

import torch

__all__ = [
    "RetryPolicy",
    "retry",
    "retry_count",
    "call_with_retry",
    "is_transient_error",
    "is_transient_io_error",
    "is_transient_cuda_error",
    "fs_write_bytes",
    "fs_read_bytes",
    "fsync_dir",
]


# ---------------------------------------------------------------------------
# error classification
# ---------------------------------------------------------------------------

# messages of the sticky CUDA faults: after one of these the context is
# lost and nothing on it can succeed again
STICKY_CUDA_SUBSTRINGS = (
    "device-side assert",
    "illegal memory access",
    "illegal address",
    "unspecified launch failure",
)

# OSError subclasses that mean "the thing is not there / is the wrong
# kind", not "the IO path hiccupped" — retrying cannot help.
_NON_TRANSIENT_OS = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    FileExistsError,
)


def is_transient_io_error(exc):
    """IO errors worth retrying: any OSError that is not a definitive
    does-not-exist / wrong-kind error."""
    return isinstance(exc, OSError) and not isinstance(exc, _NON_TRANSIENT_OS)


def is_transient_cuda_error(exc):
    """CUDA errors worth retrying: an out-of-memory error that names no
    sticky fault (see the module docstring)."""
    if not isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    msg = str(exc)
    return not any(s in msg for s in STICKY_CUDA_SUBSTRINGS)


def is_transient_error(exc):
    """Default classifier: transient IO or transient CUDA."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return False
    return is_transient_io_error(exc) or is_transient_cuda_error(exc)


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


class RetryPolicy:
    """Exponential backoff with bounded jitter.

    ``max_retries`` is the number of RE-tries: a call may run at most
    ``max_retries + 1`` times.  Delay before retry ``i`` (0-based) is
    ``min(max_delay, base_delay * multiplier**i)`` scaled by a uniform
    jitter factor in ``[1 - jitter, 1 + jitter]``.  ``classify(exc)``
    decides retryability (default: :func:`is_transient_error`);
    ``sleep``/``rng`` are injectable for deterministic tests.
    """

    def __init__(self, max_retries=3, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.25, classify=None, sleep=None,
                 rng=None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.classify = classify or is_transient_error
        self.sleep = sleep or time.sleep
        self.rng = rng or random.Random()

    def delays(self):
        """The backoff schedule: one delay per retry attempt."""
        for i in range(self.max_retries):
            base = min(self.max_delay, self.base_delay * self.multiplier ** i)
            if self.jitter:
                base *= 1.0 + self.rng.uniform(-self.jitter, self.jitter)
            yield max(0.0, base)


_DEFAULT_POLICY = RetryPolicy()


def _note_retry(exc, attempt, delay):
    """Every retry lands on the telemetry registry (counter
    ``resilience.retry``) and, when a sink is listening, emits a
    ``retry`` event."""
    from . import observability as obs

    obs.inc("resilience.retry")
    tel = obs.get_telemetry()
    if tel.recording:
        tel.emit({
            "type": "retry",
            "ts": time.time(),
            "error": repr(exc)[:200],
            "attempt": attempt,
            "delay_s": delay,
        })


def retry_count():
    """Cumulative retries performed by :func:`call_with_retry` across the
    process — a view of the ``resilience.retry`` telemetry counter."""
    from . import observability as obs

    return obs.counter("resilience.retry").value


def call_with_retry(fn, *args, policy=None, on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

    Non-retryable errors (per ``policy.classify``) re-raise immediately;
    retryable ones sleep the next backoff delay and re-run.  ``on_retry``
    (if given) is called as ``on_retry(exc, attempt, delay)`` before each
    sleep, after the built-in telemetry hook (counter
    ``resilience.retry`` + a ``retry`` event to any attached sink).
    """
    policy = policy or _DEFAULT_POLICY
    schedule = policy.delays()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as exc:
            if not policy.classify(exc):
                raise
            try:
                delay = next(schedule)
            except StopIteration:
                raise exc from None
            _note_retry(exc, attempt, delay)
            if on_retry is not None:
                on_retry(exc, attempt, delay)
            policy.sleep(delay)
            attempt += 1


def retry(policy=None, on_retry=None):
    """Decorator form of :func:`call_with_retry`::

        @retry(RetryPolicy(max_retries=5))
        def read_manifest(path): ...
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return call_with_retry(fn, *args, policy=policy,
                                   on_retry=on_retry, **kwargs)

        return wrapped

    return deco


# ---------------------------------------------------------------------------
# fault-injectable filesystem primitives
# ---------------------------------------------------------------------------

# Hooks installed by paddle_tpu_torch.testing.faults; None on the happy
# path so the cost is one attribute read.  _io_fault(path, op) raises to
# simulate an intermittent error before the real IO runs.
# _serve_fault(requests) is consulted by the serving engine's batch
# dispatch per ATTEMPT with the exact request list — raise to simulate a
# transient runtime fault, a poison request, or a worker kill; sleep to
# simulate a slow device (testing.faults.flaky_execute / slow_execute /
# poison_request / kill_worker).
_io_fault = None
_serve_fault = None


def fs_write_bytes(path, data, sync=True):
    """Write ``data`` to ``path`` (followed by flush+fsync) through the
    fault-injection choke point."""
    if _io_fault is not None:
        _io_fault(path, "write")
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        if sync:
            os.fsync(f.fileno())


def fs_read_bytes(path):
    """Read ``path`` fully, through the fault-injection choke point."""
    if _io_fault is not None:
        _io_fault(path, "read")
    with open(path, "rb") as f:
        return f.read()


def fsync_dir(dirname):
    """fsync a directory so a rename/create inside it is durable (no-op on
    platforms whose dirs can't be opened)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
