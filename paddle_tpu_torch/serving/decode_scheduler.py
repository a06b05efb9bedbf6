"""Continuous-batching decode scheduler: iteration-level sequence serving.

Counterpart of ``paddle_tpu/serving/decode_scheduler.py`` (Orca-style
iteration-level scheduling, Yu et al. OSDI'22): the decode step is ONE
fixed-width step over ``num_slots`` slots, and the scheduler admits new
sequences into free slots and retires finished ones *between*
iterations — the batch composition changes every step, the step's shape
never does.

Each worker iteration:

1. **admit** queued requests into free slots (pages reserved up front;
   no model compute at admission, except for a model without a chunk
   function: its legacy whole-prompt ``prefill_fn`` runs right there,
   padded to the prompt's bucket, and samples the first token);
2. run **at most one prefill chunk** — the prefilling slot with the
   fewest chunks left, admission order on ties.  With
   ``DecodeConfig.prefill_chunk_tokens`` unset a prompt is ONE chunk
   padded to a page-multiple bucket ladder (monolithic prefill); set, it
   is split into fixed-budget chunks interleaved with decode steps;
3. run the **decode step** over every decoding slot (inactive slots ride
   along with ``kv_lens == 0``: fully masked, exact zeros, scratch-page
   writes);
4. **retire** sequences that hit EOS or their token cap.

A sequence's tokens depend only on its own slot's row — matmul rows,
layer norm, attention over its own pages and sampling are all
row-independent — so continuous batching returns the same bits as
serving the request alone (``max_active=1``).  Sampling is keyed on
``(seed, absolute position)`` with a generator built for each sampled
row, so it is deterministic per ``(seed, prompt)`` and independent of
batch composition.  Its bits cannot match the JAX package's
``jax.random`` draws; greedy decoding matches it token for token.

The model's steps update the KV pools IN PLACE.  A failed step may have
written part of its KV, so it is not replayable and is never retried:
the port has no ``prefill_retries``/``decode_retries`` (the JAX package
forces both to 0 under pool donation for the same reason).

Admission reuses the serving contracts: bounded queue with typed
``ServingQueueFull`` backpressure, per-request deadlines shed with
``ServingTimeout`` (in queue, between chunks and mid-decode),
``GenerateRequest.cancel()``, ``ServingClosed`` after stop.  Everything
reports as ``serving.decode.*`` telemetry.  In an ``InferenceEngine`` the
``WorkerSupervisor`` watches the worker: a dead one is re-armed
(:meth:`DecodeScheduler.restart`), or past its budget its requests fail
fast (:meth:`DecodeScheduler.fail_pending`).

Not ported yet (each raises ``NotImplementedError`` naming the knob):
the prefix cache, the KV integrity guard, prefill/decode roles,
conversational sessions, and journal replay on a replica pool.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import observability as _obs
from ..core import resolve_device
from .errors import (
    ServingCancelled,
    ServingClosed,
    ServingDegraded,
    ServingError,
    ServingTimeout,
)
from .kv_cache import PagedKVCache, write_prompt_kv
from .request_queue import Request, RequestQueue
from .worker import RestartableWorker

__all__ = ["DecodeModel", "DecodeConfig", "GenerateRequest",
           "DecodeScheduler"]

_requests = _obs.counter("serving.decode.requests")
_tokens = _obs.counter("serving.decode.tokens")
_prefills = _obs.counter("serving.decode.prefills")
_steps = _obs.counter("serving.decode.steps")
_retired = _obs.counter("serving.decode.retired")
_expired = _obs.counter("serving.decode.expired")
_expired_mid_decode = _obs.counter("serving.decode.expired_mid_decode")
_expired_mid_prefill = _obs.counter("serving.decode.expired_mid_prefill")
_queue_full = _obs.counter("serving.decode.queue_full")
_cancelled = _obs.counter("serving.decode.cancelled")
_prefill_tokens = _obs.counter("serving.decode.prefill_tokens")
_queue_depth = _obs.gauge("serving.decode.queue_depth")
_active_slots = _obs.gauge("serving.decode.active_slots")
_prefill_timer = _obs.timer("serving.decode.prefill_step")
_decode_timer = _obs.timer("serving.decode.decode_step")
_queue_wait = _obs.timer("serving.decode.queue_wait")
# tail-latency histograms: queue wait, time-to-first-token (admission ->
# first sampled token) and per-iteration decode step time
_queue_wait_hist = _obs.histogram("serving.decode.queue_wait")
_ttft_hist = _obs.histogram("serving.decode.ttft")
_step_hist = _obs.histogram("serving.decode.step")


def _row_generator(seed, position):
    """A CPU generator keyed on ``(seed, absolute position)`` — the
    port's stateless stand-in for ``fold_in(PRNGKey(seed), position)``.
    The CPU generator keeps only 32 bits of its seed, so the 64-bit pair
    is mixed (splitmix64's finalizer) and folded to 32 bits first."""
    mask = 0xFFFFFFFFFFFFFFFF
    x = (((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    x ^= x >> 31
    return torch.Generator().manual_seed((x ^ (x >> 32)) & 0xFFFFFFFF)


def _sample_tokens(logits, temps, seeds, positions, top_k):
    """One token id per row of ``logits`` ([S, V], any device) as an
    int32 numpy array.  Rows with ``temps <= 0`` take the argmax; the
    others draw from the temperature-scaled (optionally top-k-truncated)
    softmax by the Gumbel-max trick, with noise from
    :func:`_row_generator` — so a row's draw depends on its own logits,
    seed and position only."""
    out = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
    for i in np.flatnonzero(temps > 0):
        z = logits[i].detach().to("cpu", torch.float64) / max(
            float(temps[i]), 1e-6)
        if top_k is not None:
            kth = torch.topk(z, top_k).values[-1]
            z = torch.where(z < kth, float("-inf"), z)
        u = torch.rand(z.shape, dtype=torch.float64,
                       generator=_row_generator(seeds[i], positions[i]))
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-300)))
        out[i] = int(torch.argmax(z + gumbel))
    return out


class DecodeModel:
    """The callables a decode-capable model exposes, and where it runs.

    ``prefill_fn(tokens[T], length) -> (last_logits[V], k[L,T,H,D],
    v[L,T,H,D])`` — run the whole (padded) prompt; ``length`` is the real
    token count, ``last_logits`` the logits at position ``length - 1``.
    LEGACY: used only by models that don't provide ``prefill_chunk_fn``;
    the scheduler scatters k/v into the prompt's pages itself
    (``kv_cache.write_prompt_kv``).

    ``prefill_chunk_fn(tokens[C], start, valid, k_pool, v_pool,
    chunk_pages[C // page_size], gather_pages[MP]) -> last_logits[V]`` —
    one resumable prefill CHUNK: write the window's k/v into
    ``chunk_pages``, attend over the sequence's ``gather_pages`` causally
    by absolute position (``start + row``); ``last_logits`` sits at row
    ``valid - 1``.  When present the scheduler prefills every prompt
    through this step (monolithic = one bucket-wide chunk), and it is
    what ``prefill_chunk_tokens`` requires.

    ``decode_fn(tokens[S], positions[S], k_pool, v_pool,
    page_tables[S,MP], kv_lens[S]) -> logits[S,V]`` — one token per
    slot: write its k/v at ``positions`` into the paged pools, attend
    over each slot's first ``kv_lens`` cached tokens.  ``kv_lens[s] ==
    0`` marks an inactive slot (masked, scratch writes).

    The chunk and decode steps update the pools IN PLACE.  Index tensors
    arrive as int32 on ``device`` (None: the card, raising without one).
    ``models.transformer.build_decode_model`` is the in-repo producer.
    """

    def __init__(self, prefill_fn, decode_fn, prefill_chunk_fn=None, *,
                 num_layers, num_heads, head_dim, vocab_size, eos_id=None,
                 device=None, name="decode-model"):
        if prefill_fn is None and prefill_chunk_fn is None:
            raise ServingError(
                "a DecodeModel needs a prefill_fn or a prefill_chunk_fn")
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.prefill_chunk_fn = prefill_chunk_fn
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.vocab_size = int(vocab_size)
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.name = name


class DecodeConfig:
    """Decode-runtime knobs (all shapes derive from these).

    num_slots: decode-step width — concurrent sequences at full load.
    page_size / max_seq_len: KV paging geometry; ``max_seq_len`` caps
        ``prompt_len + max_new_tokens`` per sequence.
    num_pages: pool size (+1 scratch).  Default reserves full worst-case
        occupancy for every slot.
    prefill_buckets: page-multiple prompt-length ladder; default doubles
        from ``page_size`` up to ``max_seq_len``.
    max_new_tokens: default per-request generation cap.
    max_active: admission cap on concurrently decoding sequences
        (default ``num_slots``); ``1`` is the per-sequence baseline.
    queue_capacity / default_deadline_ms: the admission contract.
    kv_dtype: pool dtype ("float32" or "bfloat16").
    warmup: run the decode step and every prefill width once against
        the scratch page at construction (builds the kernels, grows the
        allocator) so no live request pays for it.
    default_temperature: sampling temperature for requests that don't
        carry their own; ``0`` (the default) is greedy argmax.
    top_k: restrict sampling to the k highest logits (None = the full
        vocabulary).
    prefill_chunk_tokens: per-iteration prefill token budget (a
        page-size multiple); None prefills each prompt as ONE chunk
        padded to the bucket ladder.
    prefix_cache / kv_guard: not ported yet; True raises
        ``NotImplementedError``.
    """

    def __init__(self, num_slots=4, page_size=16, max_seq_len=256,
                 num_pages=None, prefill_buckets=None, max_new_tokens=64,
                 max_active=None, queue_capacity=128,
                 default_deadline_ms=None, kv_dtype="float32", warmup=True,
                 default_temperature=0.0, top_k=None,
                 prefill_chunk_tokens=None, prefix_cache=False,
                 kv_guard=False):
        for knob, value in (("prefix_cache", prefix_cache),
                            ("kv_guard", kv_guard)):
            if value:
                raise NotImplementedError(
                    "DecodeConfig(%s=True) is not ported to "
                    "paddle_tpu_torch yet" % knob)
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_seq_len = int(max_seq_len)
        self.num_pages = num_pages
        self.prefill_buckets = prefill_buckets
        self.max_new_tokens = int(max_new_tokens)
        self.max_active = (self.num_slots if max_active is None
                           else int(max_active))
        self.queue_capacity = int(queue_capacity)
        self.default_deadline_ms = default_deadline_ms
        self.kv_dtype = kv_dtype
        self.warmup = bool(warmup)
        self.default_temperature = float(default_temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.prefill_chunk_tokens = (None if prefill_chunk_tokens is None
                                     else int(prefill_chunk_tokens))
        self.prefix_cache = False
        self.kv_guard = False
        if self.prefill_chunk_tokens is not None:
            if (self.prefill_chunk_tokens < self.page_size
                    or self.prefill_chunk_tokens % self.page_size):
                raise ValueError(
                    "prefill_chunk_tokens must be a positive multiple of "
                    "page_size %d, got %r"
                    % (self.page_size, prefill_chunk_tokens))
        if self.default_temperature < 0:
            raise ValueError("default_temperature must be >= 0")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1 (or None for full vocab)")
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.max_active < 1 or self.max_active > self.num_slots:
            raise ValueError("max_active must be in [1, num_slots]")
        if self.max_seq_len < self.page_size:
            raise ValueError("max_seq_len must be >= page_size")


class GenerateRequest(Request):
    """One admitted generation request; doubles as the caller's future.

    ``result(timeout)`` returns the generated token ids as an int32 array
    (includes the EOS token when one stopped the sequence).
    ``token_times`` carries a ``time.perf_counter()`` stamp per
    generated token.  ``temperature``/``seed`` select the sampling mode:
    temperature ``<= 0`` (or None with a greedy default config) is
    argmax; positive temperature draws with noise keyed on ``(seed,
    absolute position)``.  ``seed=None`` defaults to the request's
    admission seq.
    """

    __slots__ = ("prompt", "max_new_tokens", "token_times", "temperature",
                 "seed", "cancelled")

    def __init__(self, prompt, max_new_tokens, deadline=None, priority=None,
                 temperature=None, seed=None):
        super().__init__(feed=None, rows=1, deadline=deadline,
                         priority=priority)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.token_times = []
        self.temperature = temperature
        self.seed = seed
        self.cancelled = False

    @property
    def prompt_len(self):
        return int(self.prompt.shape[0])

    def cancel(self):
        """Ask the runtime to drop this request: an active sequence is
        retired (pages freed) at the next iteration boundary, a queued
        one is dropped when admission reaches it — either way the future
        fails with ``ServingCancelled``.  Safe from any thread; returns
        False when the request already finished."""
        if self.done():
            return False
        self.cancelled = True
        return True


class _Slot:
    """Worker-private state of one active sequence.  It enters
    PREFILLING: ``prefill_pos`` tracks prompt tokens already cached and
    advances one chunk per scheduled iteration; the first sampled token
    (from the final chunk) flips it to decoding."""

    __slots__ = ("req", "pages", "prompt_len", "kv_len", "generated",
                 "prefill_pos")

    def __init__(self, req, pages):
        self.req = req
        self.pages = pages
        self.prompt_len = req.prompt_len
        self.kv_len = 0                # tokens written to the paged cache
        self.generated = []            # sampled tokens (last one not yet fed)
        self.prefill_pos = 0

    @property
    def prefilling(self):
        """True until the final chunk has produced the first token."""
        return self.prefill_pos < self.prompt_len or not self.generated


class DecodeScheduler:
    """Continuous-batching generation over a :class:`DecodeModel`.

    One worker thread owns the loop (admit -> prefill chunk -> decode
    step -> retire); clients only touch the bounded queue and their
    request futures.  The KV pools live on ``model.device``.
    ``role`` and ``sessions`` exist for the JAX package's signature;
    anything but their defaults raises ``NotImplementedError``, after the
    JAX package's ``ServingError`` checks (a model without
    ``prefill_chunk_fn`` takes no ``prefill_chunk_tokens``,
    ``prefix_cache`` or ``role="prefill"``).
    """

    def __init__(self, model, config=None, autostart=True, role="both",
                 sessions=None):
        cfg = self.config = config or DecodeConfig()
        self._use_chunks = model.prefill_chunk_fn is not None
        if not self._use_chunks and (cfg.prefill_chunk_tokens is not None
                                     or cfg.prefix_cache):
            raise ServingError(
                "prefill_chunk_tokens / prefix_cache require a model with "
                "prefill_chunk_fn (see models.transformer."
                "build_decode_model); %r has none" % (model.name,))
        if role not in ("both", "prefill", "decode"):
            raise ServingError(
                "role must be 'both', 'prefill', or 'decode', got %r"
                % (role,))
        if role == "prefill" and not self._use_chunks:
            raise ServingError(
                "role='prefill' requires the chunked prefill path "
                "(a model with prefill_chunk_fn)")
        if role != "both":
            raise NotImplementedError(
                "DecodeScheduler(role=%r) is not ported to paddle_tpu_torch "
                "yet" % (role,))
        if sessions is not None:
            raise NotImplementedError(
                "DecodeScheduler(sessions=...) is not ported to "
                "paddle_tpu_torch yet")
        self.model = model
        self._device = model.device
        self._cache = PagedKVCache(
            model.num_layers,
            cfg.num_pages or (
                cfg.num_slots * -(-cfg.max_seq_len // cfg.page_size) + 1),
            cfg.page_size, model.num_heads, model.head_dim,
            cfg.max_seq_len, dtype=cfg.kv_dtype, device=self._device)
        if cfg.prefill_buckets:
            buckets = sorted(set(int(b) for b in cfg.prefill_buckets))
            bad = [b for b in buckets
                   if b % cfg.page_size or b < 1 or b > cfg.max_seq_len]
            if bad:
                raise ServingError(
                    "prefill_buckets must be page_size multiples within "
                    "max_seq_len; bad: %s" % bad)
        else:
            buckets, b = [], cfg.page_size
            while b < cfg.max_seq_len:
                buckets.append(b)
                b *= 2
            buckets.append(-(-cfg.max_seq_len // cfg.page_size)
                           * cfg.page_size)
            buckets = sorted(set(buckets))
        self.prefill_buckets = tuple(buckets)
        self._top_k = (None if cfg.top_k is None
                       else min(cfg.top_k, model.vocab_size))
        self._queue = RequestQueue(
            cfg.queue_capacity, depth_gauge=_queue_depth,
            full_counter=_queue_full,
            shed_counter=_obs.counter("serving.decode.shed_admission"),
            gauge_prefix="serving.decode.queue_depth")
        self._telemetry = _obs.get_telemetry()
        self._slots = [None] * cfg.num_slots
        self._tables = np.zeros(
            (cfg.num_slots, self._cache.max_pages_per_seq), np.int32)
        self._hol = None               # head-of-line request awaiting pages
        # serializes _hol handoff between the worker and a stop() that
        # timed out joining a wedged-but-alive worker
        self._hol_lock = threading.Lock()
        self._drain = True
        self._completed = 0
        self._retired_total = 0        # SERVED retirements (service-rate EMA)
        self._worker = RestartableWorker(
            self._serve_loop, "paddle-tpu-torch-decode-scheduler",
            label="decoder")
        if cfg.warmup:
            self.warmup()
        if autostart:
            self.start()

    # -- device helpers ------------------------------------------------------
    def _dev(self, array):
        """A host numpy array as a tensor on the model's device."""
        return torch.as_tensor(array, device=self._device)

    def _chunk_widths(self):
        """The prefill widths this config can dispatch: the bucket ladder
        (monolithic or legacy), or the chunk budget plus every smaller
        ladder bucket (chunked) — a short remainder runs at its own
        bucket instead of padding to the budget."""
        if self.config.prefill_chunk_tokens is None:
            return self.prefill_buckets
        ct = self.config.prefill_chunk_tokens
        return tuple(sorted({b for b in self.prefill_buckets if b < ct}
                            | {ct}))

    def warmup(self):
        """Run the decode step and every prefill width once against the
        scratch page, so no live sequence pays the kernel build or the
        allocator's first growth."""
        cfg = self.config
        cache = self._cache
        with _obs.timed("serving.decode.warmup", slots=cfg.num_slots), \
                torch.no_grad():
            zeros = np.zeros((cfg.num_slots,), np.int32)
            self.model.decode_fn(
                self._dev(zeros), self._dev(zeros), cache.k_pool,
                cache.v_pool, self._dev(self._tables), self._dev(zeros))
            for w in self._chunk_widths():
                page_vec = np.zeros((w // cfg.page_size,), np.int32)
                if not self._use_chunks:
                    self._prefill_into(np.zeros((w,), np.int32), 1,
                                       page_vec)
                    continue
                self.model.prefill_chunk_fn(
                    self._dev(np.zeros((w,), np.int32)), 0, 1,
                    cache.k_pool, cache.v_pool, self._dev(page_vec),
                    self._dev(np.zeros((cache.max_pages_per_seq,),
                                       np.int32)))
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        return self

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self._worker.start()
        return self

    def restart(self):
        """Re-arm a DEAD worker with a fresh thread (the supervisor's
        recovery path); queue, slots, and KV state carry over — a kill
        lands between state updates, so resuming the loop continues
        every live sequence.  No-op (False) while stopping or alive."""
        return self._worker.restart()

    @property
    def started(self):
        return self._worker.started

    @property
    def alive(self):
        return self._worker.alive

    @property
    def stopping(self):
        return self._worker.stopping

    def fail_pending(self, exc):
        """Fail every queued and active request with ``exc`` — the
        supervisor's give-up path for a worker that is dead past its
        restart budget.  ``_fail_all`` mutates worker-owned slot/KV
        state, so this enforces the dead-worker precondition: under the
        worker's life lock, a live worker is left alone (returns
        False)."""
        with self._worker.life_lock:
            if self._worker.alive:
                return False
            self._fail_all(exc)
        return True

    def stop(self, drain=True, timeout=None):
        """Stop generating.  ``drain=True`` finishes every admitted and
        queued sequence first; ``drain=False`` fails them with
        ``ServingClosed`` after the in-flight iteration.  A worker that
        is still wedged when the join times out gets its QUEUED requests
        failed fast."""
        self._drain = bool(drain)
        self._worker.request_stop()
        self._queue.close()
        stopped = self._worker.join(timeout)
        if stopped:
            # leftovers exist only when the worker never ran (or was
            # asked not to drain): fail them rather than hang futures
            with self._worker.life_lock:
                self._fail_all(ServingClosed("decode scheduler stopped"))
        elif timeout is not None:
            hol = self._take_hol()
            if hol is not None:
                hol.fail(ServingClosed(
                    "engine stopped before request ran (decode worker "
                    "wedged)"))
            self._queue.drain_remaining(lambda r: ServingClosed(
                "engine stopped before request ran (decode worker "
                "wedged)"))
        return stopped

    # -- client API ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, deadline_ms=None,
               priority=None, temperature=None, seed=None):
        """Admit one prompt; returns its :class:`GenerateRequest` future.
        Raises ``ServingClosed`` when stopped, ``ServingQueueFull`` under
        backpressure, ``ServingError`` for malformed prompts."""
        cfg = self.config
        tokens = np.asarray(prompt)
        if tokens.ndim != 1 or tokens.shape[0] < 1:
            raise ServingError(
                "prompt must be a non-empty 1-D token array, got shape %s"
                % (tokens.shape,))
        tokens = tokens.astype(np.int32, copy=False)
        n_new = int(cfg.max_new_tokens if max_new_tokens is None
                    else max_new_tokens)
        if n_new < 1:
            raise ServingError("max_new_tokens must be >= 1")
        plen = int(tokens.shape[0])
        if plen > self.prefill_buckets[-1]:
            raise ServingError(
                "prompt length %d exceeds the largest prefill bucket %d"
                % (plen, self.prefill_buckets[-1]))
        if plen + n_new > cfg.max_seq_len:
            raise ServingError(
                "prompt %d + max_new_tokens %d exceeds max_seq_len %d"
                % (plen, n_new, cfg.max_seq_len))
        if temperature is not None and float(temperature) < 0:
            raise ServingError("temperature must be >= 0, got %r"
                               % (temperature,))
        ms = deadline_ms if deadline_ms is not None else cfg.default_deadline_ms
        deadline = None if ms is None else time.perf_counter() + ms / 1e3
        req = self._queue.put(
            GenerateRequest(tokens, n_new, deadline=deadline,
                            priority=priority, temperature=temperature,
                            seed=seed))
        _requests.inc()
        return req

    def generate(self, prompt, max_new_tokens=None, deadline_ms=None,
                 timeout=None, temperature=None, seed=None):
        """Synchronous generate: the generated int32 token ids."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           deadline_ms=deadline_ms, temperature=temperature,
                           seed=seed).result(timeout=timeout)

    def stats(self):
        return {
            "num_slots": self.config.num_slots,
            "max_active": self.config.max_active,
            "active": self._active_count(),
            "prefilling": sum(1 for s in self._slots
                              if s is not None and s.prefilling),
            "queue_depth": self._queue.depth(),
            "admitted": self._queue.last_seq(),
            "completed": self._completed,
            "kv_pages_free": self._cache.free_pages,
            "kv_pages_used": self._cache.used_pages,
            "kv_occupancy": self._cache.occupancy(),
            "prefill_buckets": list(self.prefill_buckets),
            "prefill_chunk_tokens": self.config.prefill_chunk_tokens,
            "device": str(self._device),
        }

    def cache_stats(self):
        """The cache allocator snapshot with the leaked-refcount sweep."""
        return self._cache.stats()

    # -- worker --------------------------------------------------------------
    def _sampling_params(self, req):
        """(temperature, seed) for one request: request overrides, else
        the config default; a seedless request gets its admission seq."""
        temp = (req.temperature if req.temperature is not None
                else self.config.default_temperature)
        seed = req.seed if req.seed is not None else (req.seq or 0)
        return np.float32(temp), np.uint32(int(seed) & 0xFFFFFFFF)

    def _active_count(self):
        return sum(1 for s in self._slots if s is not None)

    def _take_hol(self):
        """Exclusively claim the parked head-of-line request (or None)."""
        with self._hol_lock:
            req, self._hol = self._hol, None
            return req

    def _fail_all(self, exc):
        hol = self._take_hol()
        if hol is not None:
            hol.fail(exc)
        self._queue.drain_remaining(lambda r: exc)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._retire(i, error=exc)

    def _serve_loop(self):
        # (BaseException escaping this loop is the death path: the
        # RestartableWorker choke counts and reports it.)
        self._note_ts = time.perf_counter()
        self._note_retired = self._retired_total
        while True:
            self._admit()
            if self._active_count():
                if self._worker.stopping and not self._drain:
                    self._fail_all(ServingClosed("decode scheduler stopped"))
                    return
                self._iterate()
                self._note_throughput()
                continue
            # idle: re-anchor so idle gaps don't dilute the rate
            self._note_ts = time.perf_counter()
            self._note_retired = self._retired_total
            if self._worker.stopping and (not self._drain
                                          or (self._queue.depth() == 0
                                              and self._hol is None)):
                if not self._drain:
                    self._fail_all(ServingClosed("decode scheduler stopped"))
                return

    def _note_throughput(self):
        """Feed served-sequences-per-second into the queue's EMA so
        admission can shed deadline-doomed requests up front."""
        done = self._retired_total - self._note_retired
        if done <= 0:
            return
        now = time.perf_counter()
        self._queue.note_service(done, now - self._note_ts)
        self._note_ts = now
        self._note_retired = self._retired_total

    def _admit(self):
        """Fill free slots from the queue (iteration-level admission).
        Never blocks while sequences are decoding; waits briefly when
        idle so the loop doesn't spin."""
        cache, cfg = self._cache, self.config
        while self._active_count() < cfg.max_active:
            if self._worker.stopping and not self._drain:
                return
            req = self._take_hol()
            if req is None:
                req = self._queue.get(
                    timeout=0.0 if self._active_count() else 0.05)
            if req is None:
                return
            if req.cancelled:
                _cancelled.inc()
                req.fail(ServingCancelled(
                    "request cancelled before decode started"))
                self._completed += 1
                continue
            if req.expired():
                _expired.inc()
                req.fail(ServingTimeout(
                    "deadline expired after %.3fs in decode queue"
                    % (time.perf_counter() - req.enqueue_ts)))
                self._completed += 1
                continue
            need = cache.pages_for(req.prompt_len + req.max_new_tokens)
            pages = cache.alloc(need)
            if pages is None:
                if not self._active_count() and need > cache.free_pages:
                    # nothing will ever free enough: the reservation is
                    # larger than the whole (idle) pool
                    req.fail(ServingError(
                        "sequence needs %d pages but the pool has %d "
                        "usable; raise num_pages or shrink the request"
                        % (need, cache.free_pages)))
                    self._completed += 1
                    continue
                # pool exhausted: hold the head (FIFO) until a retirement
                # frees its reservation
                with self._hol_lock:
                    self._hol = req
                return
            idx = self._place(req, pages)
            if not self._use_chunks:
                self._prefill(idx)

    def _place(self, req, pages):
        """Seat one admitted request in a free slot in the PREFILLING
        state and return the slot's index: pages are reserved, but no
        model compute happens here."""
        idx = self._slots.index(None)
        now = time.perf_counter()
        wait = now - req.enqueue_ts
        _queue_wait.observe(wait)
        _queue_wait_hist.observe(wait)
        req.dispatch_ts = now
        tel = self._telemetry
        if tel.span_active() and req.trace is not None:
            tel.record_span(
                "serving.queue_wait", req.enqueue_wall, wait,
                tags=req.trace.child().tags(priority=req.priority,
                                            seq=req.seq))
        self._slots[idx] = _Slot(req, pages)
        self._tables[idx] = self._cache.table_row(pages)
        _active_slots.set(self._active_count())
        return idx

    def _prefill_into(self, tokens, length, page_vec):
        """The legacy whole-prompt prefill: ``prefill_fn`` over the padded
        ``tokens``, its k/v scattered in whole pages into ``page_vec``'s
        pages (scratch past the prompt's pages).  Returns the logits at
        ``length - 1``."""
        logits, k, v = self.model.prefill_fn(self._dev(tokens), int(length))
        write_prompt_kv(self._cache.k_pool, self._cache.v_pool, k, v,
                        self._dev(page_vec))
        return logits

    def _prefill(self, idx):
        """Prefill the just-seated slot at ``idx`` in one legacy call
        (a model without ``prefill_chunk_fn``): the prompt padded to its
        bucket, its pages written, and the first token sampled at key
        (seed, prompt length) — the key the final chunk of a chunked
        prefill uses."""
        cfg = self.config
        slot = self._slots[idx]
        req = slot.req
        plen = req.prompt_len
        bucket = next(b for b in self.prefill_buckets if b >= plen)
        tokens = np.zeros((bucket,), np.int32)
        tokens[:plen] = req.prompt
        page_vec = np.zeros((bucket // cfg.page_size,), np.int32)
        n_prompt_pages = self._cache.pages_for(plen)
        page_vec[:n_prompt_pages] = slot.pages[:n_prompt_pages]
        temp, seed = self._sampling_params(req)
        t0 = time.perf_counter()
        prefill_wall = time.time()
        try:
            with self._telemetry.timed("serving.decode.prefill",
                                       bucket=bucket, rows=plen,
                                       seq=req.seq), torch.no_grad():
                logits = self._prefill_into(tokens, plen, page_vec)
                first = int(_sample_tokens(
                    logits[None], np.array([temp]), np.array([seed]),
                    np.array([plen]), self._top_k)[0])
        except Exception as exc:  # noqa: BLE001 — worker must survive
            self._retire(idx, error=exc)
            return
        except BaseException:
            self._retire(idx, error=ServingDegraded(
                "decode worker died mid-prefill; request aborted"))
            raise
        done = time.perf_counter()
        _prefill_timer.observe(done - t0)
        _ttft_hist.observe(done - req.enqueue_ts)
        tel = self._telemetry
        if tel.span_active() and req.trace is not None:
            tel.record_span(
                "serving.execute", prefill_wall, done - t0,
                tags=req.trace.child().tags(phase="prefill", bucket=bucket,
                                            rows=plen))
        slot.prefill_pos = slot.kv_len = plen
        slot.generated.append(first)
        req.token_times.append(time.perf_counter())
        _prefills.inc()
        _prefill_tokens.inc(plen)
        _tokens.inc()
        self._finish_if_done(idx)

    def _chunk_width_for(self, remaining):
        """Dispatch width for a chunk with ``remaining`` prompt tokens
        left: the chunk budget, except a smaller remainder rides its own
        bucket (monolithic: the prompt's bucket)."""
        ct = self.config.prefill_chunk_tokens
        if ct is None:
            return next((b for b in self.prefill_buckets if b >= remaining),
                        self.prefill_buckets[-1])
        if remaining >= ct:
            return ct
        b = next((b for b in self.prefill_buckets if b >= remaining), ct)
        return min(ct, b)

    def _chunks_left(self, slot):
        remaining = slot.prompt_len - slot.prefill_pos
        return -(-remaining // self._chunk_width_for(remaining))

    def _chunk_step(self, idx):
        """Run ONE prefill chunk for the slot at ``idx``: write the next
        page-multiple token window's k/v, attend over everything cached
        so far, and — on the final chunk — sample the first token."""
        cfg = self.config
        slot = self._slots[idx]
        req = slot.req
        start = slot.prefill_pos
        remaining = req.prompt_len - start
        width = self._chunk_width_for(remaining)
        valid = min(remaining, width)
        ps = cfg.page_size
        tokens = np.zeros((width,), np.int32)
        tokens[:valid] = req.prompt[start:start + valid]
        # pages this chunk writes: the prompt's pages covering
        # [start, start + width); the window's tail past the prompt's
        # pages writes to scratch
        n_prompt_pages = self._cache.pages_for(req.prompt_len)
        p0 = start // ps
        chunk_vec = np.zeros((width // ps,), np.int32)
        for i in range(width // ps):
            if p0 + i < n_prompt_pages:
                chunk_vec[i] = slot.pages[p0 + i]
        temp, seed = self._sampling_params(req)
        t0 = time.perf_counter()
        chunk_wall = time.time()
        try:
            with self._telemetry.timed("serving.decode.prefill",
                                       bucket=width, rows=valid,
                                       start=start, seq=req.seq), \
                    torch.no_grad():
                logits = self.model.prefill_chunk_fn(
                    self._dev(tokens), start, valid, self._cache.k_pool,
                    self._cache.v_pool, self._dev(chunk_vec),
                    self._dev(self._tables[idx]))
                # the first generated token sits at absolute position
                # start + valid; only the final chunk's sample is used
                first = int(_sample_tokens(
                    logits[None], np.array([temp]), np.array([seed]),
                    np.array([start + valid]), self._top_k)[0])
        except Exception as exc:  # noqa: BLE001 — worker must survive
            self._retire(idx, error=exc)
            return
        except BaseException:
            # worker killed mid-chunk: fail the sequence typed (the
            # engine is sick, the request was fine) before the death
            # propagates
            self._retire(idx, error=ServingDegraded(
                "decode worker died mid-prefill; request aborted"))
            raise
        done = time.perf_counter()
        _prefill_timer.observe(done - t0)
        tel = self._telemetry
        if tel.span_active() and req.trace is not None:
            tel.record_span(
                "serving.execute", chunk_wall, done - t0,
                tags=req.trace.child().tags(phase="prefill", bucket=width,
                                            rows=valid, start=start))
        slot.prefill_pos = start + valid
        slot.kv_len = slot.prefill_pos
        _prefills.inc()
        _prefill_tokens.inc(valid)
        if slot.prefill_pos >= req.prompt_len:
            # final chunk: its sample is the sequence's first token
            slot.generated.append(first)
            req.token_times.append(time.perf_counter())
            _ttft_hist.observe(done - req.enqueue_ts)
            _tokens.inc()
            self._finish_if_done(idx)

    def _finish_if_done(self, idx):
        slot = self._slots[idx]
        eos = self.model.eos_id
        if (len(slot.generated) >= slot.req.max_new_tokens
                or (eos is not None and slot.generated[-1] == eos)):
            self._retire(idx)
            return True
        return False

    def _shed_expired_and_cancelled(self):
        """Retire cancelled and deadline-expired actives before burning a
        step on them — checked between chunks too, so a doomed long
        prompt frees its reservation early."""
        now0 = time.perf_counter()
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.cancelled:
                _cancelled.inc()
                self._retire(i, error=ServingCancelled(
                    "request cancelled after %d/%d generated tokens"
                    % (len(slot.generated), slot.req.max_new_tokens)))
        for i, slot in enumerate(self._slots):
            if slot is None or not slot.req.expired(now0):
                continue
            req = slot.req
            queued_s = (req.dispatch_ts or now0) - req.enqueue_ts
            running_s = (now0 - req.dispatch_ts
                         if req.dispatch_ts is not None else 0.0)
            _expired.inc()
            if slot.prefilling:
                _expired_mid_prefill.inc()
                err = ServingTimeout(
                    "deadline expired mid-prefill after %d/%d prompt "
                    "tokens (%.3fs in queue, %.3fs in prefill)"
                    % (slot.prefill_pos, slot.prompt_len,
                       max(0.0, queued_s), max(0.0, running_s)))
            else:
                _expired_mid_decode.inc()
                err = ServingTimeout(
                    "deadline expired mid-decode after %d/%d generated "
                    "tokens (%.3fs in queue, %.3fs decoding)"
                    % (len(slot.generated), req.max_new_tokens,
                       max(0.0, queued_s), max(0.0, running_s)))
            self._retire(i, error=err)

    def _iterate(self):
        cfg = self.config
        self._shed_expired_and_cancelled()
        # AT MOST ONE prefill chunk per iteration, fewest chunks left
        # first (admission order on ties), so prefill interleaves with
        # (never starves) the decode step below
        prefilling = [i for i, s in enumerate(self._slots)
                      if s is not None and s.prefilling]
        if prefilling:
            self._chunk_step(min(
                prefilling,
                key=lambda i: (self._chunks_left(self._slots[i]),
                               self._slots[i].req.seq)))
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        if not active:
            self._cache.publish_gauges(
                sum(s.kv_len for s in self._slots if s is not None))
            return
        tokens = np.zeros((cfg.num_slots,), np.int32)
        positions = np.zeros((cfg.num_slots,), np.int32)
        kv_lens = np.zeros((cfg.num_slots,), np.int32)
        seeds = np.zeros((cfg.num_slots,), np.uint32)
        temps = np.zeros((cfg.num_slots,), np.float32)
        for i, slot in active:
            tokens[i] = slot.generated[-1]   # feed the last sampled token
            positions[i] = slot.kv_len       # ... at the next cache index
            kv_lens[i] = slot.kv_len + 1     # visible kv incl. this token
            temps[i], seeds[i] = self._sampling_params(slot.req)
        # the decode step writes EVERY slot's token k/v at
        # page_tables[s, positions[s] // ps]; a PREFILLING slot's row
        # already points at its real pages, so its dispatch row must aim
        # at scratch like any other non-decoding slot, or the write
        # corrupts position 0 of its cache
        tables = self._tables
        masked = [i for i, s in enumerate(self._slots)
                  if s is not None and s.prefilling]
        if masked:
            tables = self._tables.copy()
            tables[masked] = 0
        t0 = time.perf_counter()
        try:
            with self._telemetry.timed("serving.decode.step",
                                       active=len(active)), torch.no_grad():
                logits = self.model.decode_fn(
                    self._dev(tokens), self._dev(positions),
                    self._cache.k_pool, self._cache.v_pool,
                    self._dev(tables), self._dev(kv_lens))
                # kv_lens = the sampled token's absolute position
                sampled = _sample_tokens(logits, temps, seeds, kv_lens,
                                         self._top_k)
        except Exception as exc:  # noqa: BLE001 — worker must survive
            # a failed step may have written part of its KV in place:
            # not replayable, so the active sequences fail typed
            for i, _ in active:
                self._retire(i, error=exc)
            return
        step_s = time.perf_counter() - t0
        _decode_timer.observe(step_s)
        _step_hist.observe(step_s)
        now = time.perf_counter()
        for i, slot in active:
            slot.kv_len += 1
            slot.generated.append(int(sampled[i]))
            slot.req.token_times.append(now)
        _steps.inc()
        _tokens.inc(len(active))
        for i, _ in active:
            self._finish_if_done(i)
        _active_slots.set(self._active_count())
        self._cache.publish_gauges(
            sum(s.kv_len for s in self._slots if s is not None))

    def _retire(self, idx, error=None):
        slot = self._slots[idx]
        self._slots[idx] = None
        self._tables[idx] = 0
        self._cache.free(slot.pages)
        self._completed += 1
        if error is None:
            # only SERVED sequences feed the rate EMA
            self._retired_total += 1
        req = slot.req
        if error is not None:
            req.fail(error)
        else:
            req.complete(np.asarray(slot.generated, np.int32))
        _retired.inc()
        _active_slots.set(self._active_count())
        tel = self._telemetry
        if tel.span_active():
            seq_tags = {"seq": req.seq, "prompt": slot.prompt_len,
                        "generated": len(slot.generated),
                        "shed": error is not None}
            if req.trace is not None:
                seq_tags = req.trace.child().tags(**seq_tags)
            tel.record_span(
                "serving.decode.sequence", req.enqueue_wall,
                time.time() - req.enqueue_wall, tags=seq_tags)
        if tel.recording:
            tel.emit({
                "type": "decode_sequence", "ts": time.time(),
                "source": "serving", "seq": req.seq,
                "prompt_len": slot.prompt_len,
                "generated": len(slot.generated),
                "shed": error is not None,
                "kv_pages_used": self._cache.used_pages,
                "queue_depth": self._queue.depth(),
            })
