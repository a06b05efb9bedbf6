"""Continuous-batching decode scheduler: iteration-level sequence serving.

Counterpart of ``paddle_tpu/serving/decode_scheduler.py`` (Orca-style
iteration-level scheduling, Yu et al. OSDI'22): the decode step is ONE
fixed-width step over ``num_slots`` slots, and the scheduler admits new
sequences into free slots and retires finished ones *between*
iterations — the batch composition changes every step, the step's shape
never does.

Each worker iteration:

1. **admit** queued requests into free slots (pages reserved up front,
   a prefix-cache probe first when ``prefix_cache`` is on; no model
   compute at admission, except for a model without a chunk function:
   its legacy whole-prompt ``prefill_fn`` runs right there, padded to
   the prompt's bucket, and samples the first token);
2. run **at most one prefill chunk** — the prefilling slot with the
   fewest chunks left, admission order on ties.  With
   ``DecodeConfig.prefill_chunk_tokens`` unset a prompt is ONE chunk
   padded to a page-multiple bucket ladder (monolithic prefill); set, it
   is split into fixed-budget chunks interleaved with decode steps;
3. run the **decode step** over every decoding slot (inactive slots ride
   along with ``kv_lens == 0``: fully masked, exact zeros, scratch-page
   writes);
4. **retire** sequences that hit EOS or their token cap.

**Compiled steps.**  Every dispatch goes through an
:class:`~paddle_tpu_torch.executor.JitStepCache` under the JAX package's
keys: ``("decode",)``, ``("chunk", width)`` (chunked and monolithic
prefill), ``("prefill", bucket)`` (the legacy whole-prompt prefill) and
``("kvguard", n)``.  On the card an entry is a CUDA graph: ``warmup()``
calls each entry twice (the first call warms, the second captures), so
a live step is one upload of its packed int32 inputs, one replay and one
read of its sampled ids, and ``executor.compile_count()`` does not move
in steady state.  The pools are never arguments of a step: each step
closes over the cache's ``k_pool``/``v_pool`` and writes them in place
(an argument would be copied into the graph's static inputs every call),
so nothing may rebind them.  The greedy argmax runs inside the step;
rows with ``temperature > 0`` draw on the host from the step's logits.

A sequence's tokens depend only on its own slot's row — matmul rows,
layer norm, attention over its own pages and sampling are all
row-independent — so continuous batching returns the same bits as
serving the request alone (``max_active=1``).  Sampling is keyed on
``(seed, absolute position)`` with a generator built for each sampled
row, so it is deterministic per ``(seed, prompt)`` and independent of
batch composition.  Its bits cannot match the JAX package's
``jax.random`` draws; greedy decoding matches it token for token.

**Prefix caching** (``DecodeConfig.prefix_cache=True``): admission
probes the KV cache's content-hash page index with the prompt's chain
hashes and maps the cached leading full pages read-only (refcounted, see
:mod:`~paddle_tpu_torch.serving.kv_cache`); only the uncached tail is
prefilled, resuming at a page boundary at the smallest warmed width
that covers it, and each full page a chunk writes is registered.

**Durability**: every request carries a host-side :class:`DecodeJournal`
(the original prompt and the accepted tokens, no KV).
:meth:`DecodeScheduler.evict_inflight` harvests the in-flight sequences
(pages freed, futures untouched) and :meth:`DecodeScheduler.resubmit`
re-admits one anywhere from ``prompt + accepted``; sampling keyed on the
absolute position makes the continuation the fault-free tokens.  The
opt-in ``kv_guard`` sweeps the pages each chunk and decode step wrote
for non-finite values and fails exactly the owning sequence
(``KVCorruption``), its pages scrubbed in place.

The model's steps update the KV pools IN PLACE.  A failed step may have
written part of its KV, so it is not replayable and is never retried:
the port has no ``prefill_retries``/``decode_retries`` (the JAX package
forces both to 0 under pool donation for the same reason).  The fault
choke point ``resilience._serve_fault`` is consulted before the legacy
prefill, each chunk and each decode dispatch.

Admission reuses the serving contracts: bounded queue with typed
``ServingQueueFull`` backpressure, per-request deadlines shed with
``ServingTimeout`` (in queue, between chunks and mid-decode),
``GenerateRequest.cancel()``, ``ServingClosed`` after stop.  Everything
reports as ``serving.decode.*`` telemetry.  In an ``InferenceEngine`` the
``WorkerSupervisor`` watches the worker: a dead one is re-armed
(:meth:`DecodeScheduler.restart`), or past its budget its requests fail
fast (:meth:`DecodeScheduler.fail_pending`).

**Pool mode** (:class:`~.replica_pool.ReplicaPool`): ``queue=`` is the
pool's SHARED admission queue (the scheduler never closes or drains
it), ``gate=`` a claim predicate consulted before every shared-queue
pull (never for a parked head-of-line request, whose prefix pages are
pinned here), ``claim=`` the per-pop predicate the queue runs under its
lock (``RequestQueue.get(accept=)``), ``name=`` the worker thread's name
(``decode-replica<i>``, which the supervisor and
``testing.faults.kill_replica_mid_decode`` address), ``breaker=`` a
:class:`~.resilient.CircuitBreaker` told the outcome of every dispatch,
``stream=`` the CUDA stream the worker's loop runs on, and
``evict_on_death=True`` leaves a killed worker's sequences in their
slots for the pool to harvest (:meth:`DecodeScheduler.evict_if_dead`)
and replay on a sibling under ``DecodeConfig.replay_budget``.

**Sessions** (``sessions=``, a :class:`~.sessions.SessionStore`
shared by a pool's replicas; requires ``prefix_cache``): a request
tagged ``session=`` that retires without error *parks* — its full
prompt pages (the pages a prefill chunk wrote, ROADMAP F-13) are
registered in the prefix index and pinned with one extra refcount each,
and the store records this replica as the conversation's owner, so the
next turn (the whole history plus a new message) maps them instead of
prefilling them again.  Pins move only the allocator's host-side
refcounts; the pools stay where the captured steps read them.  The
allocator belongs to the worker: another thread's release
(:meth:`DecodeScheduler.release_session_pins`, the store's TTL sweep,
capacity eviction, ``end_session``) is queued and drained at the top of
the worker's next iteration, or at once under the worker's life lock
when the worker is provably dead.

**Roles** (``role=``): a ``"prefill"`` replica prefills a prompt and
samples its first token, then stages the sequence's KV pages on the
host as a :class:`HandoffPacket` (``index_select`` on the pools, a
``non_blocking`` copy into pinned host memory on the replica's stream,
and a wait on an event recorded after it) and hands it to
``on_handoff``; its pages are freed, the full prompt pages staying
indexed at refcount 0.  A ``"decode"`` replica takes packets through
:meth:`DecodeScheduler.inject_handoff`, ahead of fresh queue work: it
copies the packet to the device on its own stream, writes it with
``index_copy_`` into freshly allocated pages, in place, re-registers the
prompt's full pages and seats the slot already decoding.  Both legs are
eager torch ops, outside the step cache; a warm-up runs each once at
its largest size so the first handoff under load allocates nothing new
on the device.  The KV always crosses through the host, so a waiting
packet holds no pool pages.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from .. import observability as _obs
from .. import resilience as _resilience
from ..core import resolve_device
from ..executor import JitStepCache
from ..parallel.flash_attention import paged_kv_finite
from .errors import (
    KVCorruption,
    ServingCancelled,
    ServingClosed,
    ServingDegraded,
    ServingError,
    ServingTimeout,
)
from .kv_cache import PagedKVCache, write_prompt_kv
from .request_queue import Request, RequestQueue
from .worker import RestartableWorker

__all__ = ["DecodeModel", "DecodeConfig", "DecodeJournal",
           "GenerateRequest", "DecodeScheduler", "HandoffPacket"]

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
_kv_guard_trips = _obs.counter("serving.decode.kv_guard_trips")
_affinity_honored = _obs.counter("serving.affinity.honored")
# prefill -> decode KV handoffs (roles) and session pins
_handoff_packets = _obs.counter("serving.handoff.packets")
_handoff_pages = _obs.counter("serving.handoff.pages")
_handoff_bytes = _obs.counter("serving.handoff.bytes")
_handoff_injected = _obs.counter("serving.handoff.injected")
_handoff_failed = _obs.counter("serving.handoff.failed")
_handoff_stage_timer = _obs.timer("serving.handoff.stage")
# the same seconds by leg, so the gather and the scatter read apart
_handoff_leg_timers = {
    leg: _obs.timer("serving.handoff.stage", labels={"leg": leg})
    for leg in ("gather", "scatter")}


def _observe_stage(leg, t0):
    """A handoff leg's seconds since ``t0``, on the stage timer and on
    the leg's own."""
    seconds = time.perf_counter() - t0
    _handoff_stage_timer.observe(seconds)
    _handoff_leg_timers[leg].observe(seconds)
_session_parked_pages = _obs.counter("serving.session.pinned")
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


def _greedy(logits):
    """The argmax ids of ``logits`` ([V] or [S, V]) as an int32 vector,
    computed inside a step (one small device-to-host copy a step)."""
    return torch.argmax(logits, dim=-1).to(torch.int32).reshape(-1)


def _sample_tokens(greedy, logits, temps, seeds, positions, top_k):
    """One token id per row as an int32 numpy array.  Rows with
    ``temps <= 0`` keep their argmax from ``greedy`` (the step's int32
    ids); the others draw from the temperature-scaled (optionally
    top-k-truncated) softmax of their row of ``logits`` ([S, V], any
    device) by the Gumbel-max trick, with noise from
    :func:`_row_generator` — so a row's draw depends on its own logits,
    seed and position only."""
    out = greedy.cpu().numpy().astype(np.int32)
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


def _unpack(flat, sizes):
    """Consecutive slices of the packed int32 input ``flat``, one of each
    size in ``sizes``: views, contiguous, so a captured step reads its
    static input buffer in place."""
    out, at = [], 0
    for n in sizes:
        out.append(flat[at:at + n])
        at += n
    return out


def _pack(*parts):
    """One int32 host vector of ``parts`` (arrays or ints), in order."""
    return np.concatenate([np.asarray(p, np.int32).reshape(-1)
                           for p in parts])


class DecodeModel:
    """The callables a decode-capable model exposes, and where it runs.

    ``prefill_fn(tokens[T], length) -> (last_logits[V], k[L,T,H,D],
    v[L,T,H,D])`` — run the whole (padded) prompt; ``length`` ([1] int32
    on ``device``) is the real token count, ``last_logits`` the logits at
    position ``length - 1``.  LEGACY: used only by models that don't
    provide ``prefill_chunk_fn``; the scheduler scatters k/v into the
    prompt's pages itself (``kv_cache.write_prompt_kv``).

    ``prefill_chunk_fn(tokens[C], start, valid, k_pool, v_pool,
    chunk_pages[C // page_size], gather_pages[MP]) -> last_logits[V]`` —
    one resumable prefill CHUNK: write the window's k/v into
    ``chunk_pages``, attend over the sequence's ``gather_pages`` causally
    by absolute position (``start + row``); ``last_logits`` sits at row
    ``valid - 1``.  ``start``/``valid`` are [1] int32 on ``device``.
    When present the scheduler prefills every prompt through this step
    (monolithic = one bucket-wide chunk), and it is what
    ``prefill_chunk_tokens`` and ``prefix_cache`` require.

    ``decode_fn(tokens[S], positions[S], k_pool, v_pool,
    page_tables[S,MP], kv_lens[S]) -> logits[S,V]`` — one token per
    slot: write its k/v at ``positions`` into the paged pools, attend
    over each slot's first ``kv_lens`` cached tokens.  ``kv_lens[s] ==
    0`` marks an inactive slot (masked, scratch writes).

    The chunk and decode steps update the pools IN PLACE.  Index tensors
    arrive as int32 on ``device`` (None: the card, raising without one),
    and a function must not read a value on the host: on the card each
    is captured once a shape and replayed.
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
    warmup: build every step at construction — the decode step, every
        prefill width and (with ``kv_guard``) every guard length, run
        against the scratch page; on the card each is called twice, so
        its CUDA graph is captured before any request arrives.
    default_temperature: sampling temperature for requests that don't
        carry their own; ``0`` (the default) is greedy argmax.
    top_k: restrict sampling to the k highest logits (None = the full
        vocabulary).
    prefill_chunk_tokens: per-iteration prefill token budget (a
        page-size multiple); None prefills each prompt as ONE chunk
        padded to the bucket ladder.
    prefix_cache: probe the KV pool's content-hash page index at
        admission and map cached prompt-prefix pages read-only instead
        of recomputing them (refcounted sharing, LRU eviction of
        refcount-zero pages).  Requires ``prefill_chunk_fn``.
        Generated tokens are the same warm and cold.
    kv_guard: after every prefill chunk and decode step, an isfinite
        sweep over the pages it wrote; a non-finite write fails exactly
        the owning sequence with ``KVCorruption`` and scrubs its pages.
        One small graph and a read of its N booleans a step; off by
        default.
    replay_budget: times a replica pool may re-admit a sequence after
        the replica serving it died (a re-prefill of ``prompt +
        accepted`` on a sibling, continuing the same tokens) before it
        fails with ``ServingDegraded``.  Only the pool reads it.
    """

    def __init__(self, num_slots=4, page_size=16, max_seq_len=256,
                 num_pages=None, prefill_buckets=None, max_new_tokens=64,
                 max_active=None, queue_capacity=128,
                 default_deadline_ms=None, kv_dtype="float32", warmup=True,
                 default_temperature=0.0, top_k=None,
                 prefill_chunk_tokens=None, prefix_cache=False,
                 replay_budget=2, kv_guard=False):
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
        self.prefix_cache = bool(prefix_cache)
        self.replay_budget = int(replay_budget)
        self.kv_guard = bool(kv_guard)
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


class DecodeJournal:
    """Host-side record of one generation — the replay unit.

    Holds the ORIGINAL prompt and generation cap plus every accepted
    token, O(tokens) host memory and no KV: with the request's sampling
    knobs (seed/temperature) this is a sequence's complete decode state.
    :meth:`DecodeScheduler.resubmit` re-admits a request from
    :meth:`resume_prompt` with :meth:`remaining` as its cap, and
    sampling keyed on the absolute position continues the uninterrupted
    run.  ``replays`` counts re-admissions.
    """

    __slots__ = ("prompt0", "max_new0", "accepted", "replays")

    def __init__(self, prompt, max_new_tokens):
        self.prompt0 = prompt
        self.max_new0 = int(max_new_tokens)
        self.accepted = []           # every token the client will receive
        self.replays = 0

    def remaining(self):
        return self.max_new0 - len(self.accepted)

    def resume_prompt(self):
        """``prompt + accepted`` — what a replay prefills.  Its chain
        hashes over the original prompt are the prompt's own, so
        surviving prefix-cache pages answer warm."""
        return np.concatenate(
            [np.asarray(self.prompt0, np.int32),
             np.asarray(self.accepted, np.int32)])

    def tokens(self):
        """The accepted tokens as the client-facing int32 array."""
        return np.asarray(self.accepted, np.int32)


class GenerateRequest(Request):
    """One admitted generation request; doubles as the caller's future.

    ``result(timeout)`` returns the generated token ids as an int32 array
    (includes the EOS token when one stopped the sequence).
    ``token_times`` carries a ``time.perf_counter()`` stamp per
    generated token.  ``temperature``/``seed`` select the sampling mode:
    temperature ``<= 0`` (or None with a greedy default config) is
    argmax; positive temperature draws with noise keyed on ``(seed,
    absolute position)``.  ``seed=None`` defaults to the request's
    admission seq (:meth:`DecodeScheduler.resubmit` pins it first).

    ``journal`` is the request's :class:`DecodeJournal`; ``prompt`` /
    ``max_new_tokens`` are the CURRENT incarnation's (rewritten by a
    resubmit), the journal keeps the originals and the accepted tokens.
    ``affinity`` / ``affinity_ts``: a replica pool's dispatch hint (the
    preferred replica's index and when it was stamped), never a
    requirement: a gate strips a stale or unservable one.  ``session``:
    the conversation key (opaque) a successful retirement parks under;
    ``handoff_origin``: the prefill replica that staged this request's
    KV handoff (roles), which stays the session's sticky replica.
    """

    __slots__ = ("prompt", "max_new_tokens", "token_times", "temperature",
                 "seed", "journal", "cancelled", "session", "affinity",
                 "affinity_ts", "handoff_origin")

    def __init__(self, prompt, max_new_tokens, deadline=None, priority=None,
                 temperature=None, seed=None, session=None):
        super().__init__(feed=None, rows=1, deadline=deadline,
                         priority=priority)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.token_times = []
        self.temperature = temperature
        self.seed = seed
        self.journal = DecodeJournal(prompt, max_new_tokens)
        self.cancelled = False
        self.session = session
        self.affinity = None
        self.affinity_ts = None
        self.handoff_origin = None

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
    PREFILLING: ``prefill_pos`` tracks prompt tokens already cached
    (starting past any prefix-cache hit) and advances one chunk per
    scheduled iteration; the first sampled token (from the final chunk)
    flips it to decoding."""

    __slots__ = ("req", "pages", "prompt_len", "kv_len", "generated",
                 "prefill_pos", "hashes")

    def __init__(self, req, pages, prefill_pos=0, hashes=None):
        self.req = req
        self.pages = pages
        self.prompt_len = req.prompt_len
        self.kv_len = int(prefill_pos)  # tokens written to the paged cache
        self.generated = []            # sampled tokens (last one not yet fed)
        self.prefill_pos = int(prefill_pos)
        self.hashes = hashes           # prompt chain hashes (prefix cache)

    @property
    def prefilling(self):
        """True until the final chunk has produced the first token."""
        return self.prefill_pos < self.prompt_len or not self.generated


class HandoffPacket:
    """Host-staged KV of one fully prefilled sequence in transit from a
    prefill-role replica to a decode-role one.

    ``k_host``/``v_host`` hold only the sequence's ``n_pages`` pages,
    ``[L, n_pages, page_size, H, D]`` in the pool's dtype, in pinned
    host memory on the card (the JAX package gathers a fixed
    ``[L, max_pages_per_seq, ...]`` so that one jitted program serves
    every length; torch has no such compile cost, so no scratch rows
    cross).  ``serving.handoff.bytes`` counts these bytes, without the
    JAX package's scratch rows.  ``first`` is the first sampled token
    (already journaled on the origin), ``hashes`` the prompt's chain
    hashes, so the destination re-registers the prefix.
    """

    __slots__ = ("req", "k_host", "v_host", "n_pages", "kv_len",
                 "hashes", "origin", "first")

    def __init__(self, req, k_host, v_host, n_pages, kv_len, hashes,
                 origin, first):
        self.req = req
        self.k_host = k_host
        self.v_host = v_host
        self.n_pages = int(n_pages)
        self.kv_len = int(kv_len)
        self.hashes = hashes
        self.origin = int(origin)
        self.first = int(first)


class DecodeScheduler:
    """Continuous-batching generation over a :class:`DecodeModel`.

    One worker thread owns the loop (admit -> prefill chunk -> decode
    step -> retire); clients only touch the bounded queue and their
    request futures.  The KV pools live on ``model.device``.  ``queue``,
    ``gate``, ``claim``, ``name``, ``evict_on_death``, ``breaker``,
    ``replica_index`` and ``stream`` are the pool-mode hooks (see the
    module docstring); ``replica_index`` also counts
    ``serving.affinity.honored`` when a pulled request's hint names this
    replica.  ``sessions`` (a shared :class:`~.sessions.SessionStore`),
    ``role`` (``"both"``, ``"prefill"`` or ``"decode"``) and
    ``on_handoff`` (a prefill replica's packet sink, returning True once
    a decode replica took the packet) are the sessions and roles hooks
    (see the module docstring).  A model without ``prefill_chunk_fn``
    takes no ``prefill_chunk_tokens``, ``prefix_cache`` or
    ``role="prefill"``, and sessions require ``prefix_cache``.
    """

    def __init__(self, model, config=None, autostart=True, queue=None,
                 gate=None, name=None, evict_on_death=False, breaker=None,
                 sessions=None, replica_index=0, role="both",
                 on_handoff=None, claim=None, stream=None):
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
        if sessions is not None and not cfg.prefix_cache:
            raise ServingError(
                "sessions require prefix_cache=True: a session pin is an "
                "extra refcount on the prompt's prefix-index chain")
        # the store is SHARED by a pool's replicas; each scheduler parks
        # into it and releases pins against its OWN cache only
        self._sessions = sessions
        self._role = role
        self._on_handoff = on_handoff
        # cross-thread queues: other threads (the store's sweeps, a
        # sibling's handoff dispatch) only enqueue here; the worker
        # drains them each iteration, or the enqueuer under the life lock
        # once the worker is provably dead
        self._pending_lock = threading.Lock()
        self._pending_release = []
        self._pending_handoffs = collections.deque()
        self._copied = None            # the gather's event (on the card)
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
        self._owns_queue = queue is None
        self._queue = queue if queue is not None else RequestQueue(
            cfg.queue_capacity, depth_gauge=_queue_depth,
            full_counter=_queue_full,
            shed_counter=_obs.counter("serving.decode.shed_admission"),
            gauge_prefix="serving.decode.queue_depth")
        self._gate = gate
        self._claim = claim
        self._breaker = breaker
        self._evict_on_death = bool(evict_on_death)
        self._replica_index = int(replica_index)
        self._stream = stream
        self._telemetry = _obs.get_telemetry()
        self._slots = [None] * cfg.num_slots
        self._tables = np.zeros(
            (cfg.num_slots, self._cache.max_pages_per_seq), np.int32)
        # reset_pools refuses to zero pages under these sequences unless
        # its caller says force=True
        self._cache.live_seqs = lambda: [
            s.req.seq for s in self._slots if s is not None]
        # the compiled steps (a CUDA graph each on the card), under the
        # JAX package's keys and cap
        self._jit = JitStepCache(
            self._build_step, cap=2 * len(self.prefill_buckets) + 12,
            name="decode-steps")
        # the parked head-of-line entry: (request, pinned prefix pages,
        # chain hashes), or None
        self._hol = None
        # serializes _hol handoff between the worker and a stop() that
        # timed out joining a wedged-but-alive worker
        self._hol_lock = threading.Lock()
        self._drain = True
        self._completed = 0
        self._retired_total = 0        # SERVED retirements (service-rate EMA)
        self._worker = RestartableWorker(
            self._serve_loop, name or "paddle-tpu-torch-decode-scheduler",
            label=name or "decoder")
        if cfg.warmup:
            self.warmup()
        if autostart:
            self.start()

    # -- compiled steps ------------------------------------------------------
    def _build_step(self, key):
        """The step of a JitStepCache key.  Each takes ONE packed int32
        vector (see the callers for its layout) and closes over the model
        and the cache — never the scheduler, never the pools as
        arguments: the pools are read from the cache at each call and
        written in place, so a step captured on the card writes the
        cache's own tensors."""
        model, cache = self.model, self._cache
        S, ps = self.config.num_slots, self.config.page_size
        mp = cache.max_pages_per_seq
        kind = key[0]
        if kind == "kvguard":
            def kvguard(pages):
                return paged_kv_finite(cache.k_pool, cache.v_pool, pages)

            return kvguard
        if kind == "decode":
            def decode(ints):
                tokens, positions, kv_lens, tables = _unpack(
                    ints, (S, S, S, S * mp))
                logits = model.decode_fn(
                    tokens, positions, cache.k_pool, cache.v_pool,
                    tables.view(S, mp), kv_lens)
                return logits, _greedy(logits)

            return decode
        width = key[1]
        if kind == "chunk":
            def chunk(ints):
                tokens, start, valid, chunk_pages, gather = _unpack(
                    ints, (width, 1, 1, width // ps, mp))
                logits = model.prefill_chunk_fn(
                    tokens, start, valid, cache.k_pool, cache.v_pool,
                    chunk_pages, gather)
                return logits, _greedy(logits)

            return chunk
        if kind != "prefill":
            raise ValueError("unknown decode step key %r" % (key,))

        def prefill(ints):
            tokens, length, pages = _unpack(ints, (width, 1, width // ps))
            logits, k, v = model.prefill_fn(tokens, length)
            write_prompt_kv(cache.k_pool, cache.v_pool, k, v, pages)
            return logits, _greedy(logits)

        return prefill

    def _dev(self, array):
        """A packed host int32 vector on the model's device: on the card
        through pinned memory with a copy that does not wait (the host
        allocator keeps the pinned block until the copy is done)."""
        t = torch.from_numpy(np.ascontiguousarray(array, np.int32))
        if self._device.type != "cuda":
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def _run_step(self, key, ints):
        """Dispatch the compiled step ``key`` on the packed inputs."""
        return self._jit.get(key)(self._dev(ints))

    def _chunk_widths(self):
        """The prefill widths this config can dispatch: the bucket ladder
        (monolithic or legacy), or the chunk budget plus every smaller
        ladder bucket (chunked) — a short remainder, or the uncached
        tail of a prefix-cache hit, runs at its own bucket instead of
        padding to the budget."""
        if self.config.prefill_chunk_tokens is None:
            return self.prefill_buckets
        ct = self.config.prefill_chunk_tokens
        return tuple(sorted({b for b in self.prefill_buckets if b < ct}
                            | {ct}))

    def _guard_lengths(self):
        """The page-vector lengths the KV guard sweeps: the decode
        step's tail pages and each prefill width's pages."""
        ps = self.config.page_size
        return sorted({self.config.num_slots}
                      | {w // ps for w in self._chunk_widths()})

    def warmup(self):
        """Build every step this config dispatches and run it against the
        scratch page — on the card twice, so its CUDA graph is captured
        now and no live sequence pays a build or a capture."""
        cfg = self.config
        mp = self._cache.max_pages_per_seq
        S, ps = cfg.num_slots, cfg.page_size
        calls = 2 if self._device.type == "cuda" else 1
        runs = [(("decode",), np.zeros(3 * S + S * mp, np.int32))]
        for w in self._chunk_widths():
            tokens, pages = np.zeros(w), np.zeros(w // ps)
            if self._use_chunks:
                runs.append((("chunk", w),
                             _pack(tokens, 0, 1, pages, np.zeros(mp))))
            else:
                runs.append((("prefill", w), _pack(tokens, 1, pages)))
        if cfg.kv_guard:
            runs += [(("kvguard", n), np.zeros(n, np.int32))
                     for n in self._guard_lengths()]
        with _obs.timed("serving.decode.warmup", slots=cfg.num_slots), \
                torch.no_grad():
            for key, ints in runs:
                for _ in range(calls):
                    self._run_step(key, ints)
            self.warm_handoff()
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        return self

    def warm_handoff(self):
        """Roles: run the handoff leg this replica runs once at its
        largest size, against the scratch page, so that the caching
        allocator holds the blocks the first handoff under load needs.
        :meth:`warmup` calls it; a pool calls it again once its last
        replica has warmed, since every capture first hands the cached
        free blocks back to the device."""
        c = self._cache
        scratch = [0] * c.max_pages_per_seq
        with torch.no_grad():
            if self._role == "prefill" and self._on_handoff is not None:
                self._hgather(scratch)
            if self._role == "decode":
                zero = torch.zeros(
                    (c.num_layers, c.max_pages_per_seq, c.page_size,
                     c.num_heads, c.head_dim), dtype=c.dtype)
                if self._device.type == "cuda":
                    zero = zero.pin_memory()
                self._hscatter(zero, zero, scratch)

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
        failed fast.  Once the worker has exited, the step graphs and the
        KV pools are dropped: a stopped scheduler holds no device
        memory."""
        self._drain = bool(drain)
        self._worker.request_stop()
        if self._owns_queue:
            self._queue.close()
        stopped = self._worker.join(timeout)
        if stopped:
            # leftovers exist only when the worker never ran (or was
            # asked not to drain): fail them rather than hang futures
            with self._worker.life_lock:
                self._fail_all(ServingClosed("decode scheduler stopped"))
                self._release_device_memory()
        elif timeout is not None:
            hol = self._take_hol()
            if hol is not None:
                # the future only: the wedged worker still owns the
                # cache, so its pinned prefix pages stay referenced
                hol[0].fail(ServingClosed(
                    "engine stopped before request ran (decode worker "
                    "wedged)"))
            if self._owns_queue:
                self._queue.drain_remaining(lambda r: ServingClosed(
                    "engine stopped before request ran (decode worker "
                    "wedged)"))
        return stopped

    def _release_device_memory(self):
        """With the worker gone: wait for the work it queued on the card,
        then drop the step graphs (their private pools with them) and the
        KV pools, so a stopped scheduler holds no device memory."""
        if self._device.type == "cuda":
            (self._stream if self._stream is not None
             else torch.cuda.default_stream(self._device)).synchronize()
        self._jit.clear()
        self._cache.release_pools()

    # -- client API ----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, deadline_ms=None,
               priority=None, temperature=None, seed=None, session=None):
        """Admit one prompt; returns its :class:`GenerateRequest` future.
        Raises ``ServingClosed`` when stopped, ``ServingQueueFull`` under
        backpressure, ``ServingError`` for malformed prompts.
        ``session`` tags the request as a turn of that conversation
        (parked at retirement when the scheduler has ``sessions``)."""
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
                            seed=seed, session=session))
        _requests.inc()
        return req

    def generate(self, prompt, max_new_tokens=None, deadline_ms=None,
                 timeout=None, temperature=None, seed=None, session=None):
        """Synchronous generate: the generated int32 token ids."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           deadline_ms=deadline_ms, temperature=temperature,
                           seed=seed, session=session).result(timeout=timeout)

    def resubmit(self, req):
        """Re-admit a request harvested by :meth:`evict_inflight` (here
        or on another scheduler of the same model): it resumes from its
        journal — ``prompt + accepted`` prefilled, the remaining cap as
        its budget — and completes with every accepted token, the same
        tokens the uninterrupted run gives.  A seedless request's seed
        is pinned to its first admission's seq first.  Returns the
        request (already complete when nothing remained)."""
        if req.done():
            return req
        j = req.journal
        if j.remaining() <= 0:
            req.complete(j.tokens())
            return req
        prompt = j.resume_prompt()
        if (len(prompt) > self.prefill_buckets[-1]
                or len(prompt) + j.remaining() > self.config.max_seq_len):
            raise ServingError(
                "resumed prompt %d + %d tokens does not fit this "
                "scheduler's buckets / max_seq_len"
                % (len(prompt), j.remaining()))
        if req.seed is None:
            req.seed = req.seq or 0
        j.replays += 1
        req.prompt = prompt
        req.max_new_tokens = j.remaining()
        # a fresh seq and enqueue stamp; the deadline stays absolute
        self._queue.put(req)
        _requests.inc()
        return req

    def stats(self):
        st = {
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
            "prefix_cache": self.config.prefix_cache,
            "role": self._role,
            "device": str(self._device),
        }
        if self.config.prefix_cache:
            st["prefix"] = self._cache.prefix_stats()
        return st

    def cache_stats(self):
        """The cache allocator snapshot with the leaked-refcount sweep."""
        return self._cache.stats()

    def step_stats(self):
        """Each compiled step by key: whether it is a captured CUDA graph,
        the capture's seconds and the bytes its private pool added to the
        card's reserved memory (None on the CPU)."""
        return {key: {"captured": e.captured, "capture_s": e.capture_s,
                      "pool_bytes": e.pool_bytes}
                for key, e in self._jit.items()}

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

    def free_slots(self):
        """Seats this scheduler could fill now: the pool's least-loaded
        signal, read from other threads (a snapshot; a stale one only
        skews one claim)."""
        return self.config.max_active - self._active_count()

    def _take_hol(self):
        """Exclusively claim the parked head-of-line entry — a
        ``(request, pinned prefix pages, chain hashes)`` triple — or
        None: the worker, a wedged-timeout stop(), and _fail_all all
        hand off through here so exactly one owner ever fails/serves
        it."""
        with self._hol_lock:
            entry, self._hol = self._hol, None
            return entry

    def _park_hol(self, req, cached_pages, hashes):
        """Park the head-of-line request WITH its prefix-probe result:
        the hit pages stay pinned while parked, so the request isn't
        re-probed (and the hit/miss counters not re-counted) every
        iteration the pool stays exhausted, and its prefix can't be
        evicted out from under it."""
        with self._hol_lock:
            self._hol = (req, cached_pages, hashes)

    # -- sessions & handoff (cross-thread entry points) ----------------------
    def release_session_pins(self, pages):
        """Release session-pinned pages back to this scheduler's cache.
        Safe from any thread (the SessionStore's release callback, fired
        by TTL sweeps, capacity evictions and end_session): the pages
        are queued and freed on the worker at its next iteration, or
        here under the life lock when the worker is provably dead."""
        with self._pending_lock:
            self._pending_release.extend(int(p) for p in pages)
        self.drain_pending_releases()

    def drain_pending_releases(self):
        """Apply queued pin releases if the worker is provably dead;
        no-op (False) otherwise, since a live worker drains its own
        queue.  The pool calls this after stopping a replica, so
        ``SessionStore.clear()``'s releases land with every worker
        gone."""
        with self._worker.life_lock:
            if self._worker.alive:
                return False
            self._drain_pending()
        return True

    def _drain_pending(self):
        """Free the queued session-pin releases (the worker thread, or a
        thread holding the dead-worker proof)."""
        with self._pending_lock:
            pages, self._pending_release = self._pending_release, []
        if pages:
            self._cache.free(pages)

    def inject_handoff(self, packet):
        """Queue a prefilled sequence's staged KV for seating on this
        (decode-role) replica; called by the pool's handoff dispatch on
        the origin replica's worker thread.  False when this scheduler
        is stopping (the caller re-routes or fails the request)."""
        if self._worker.stopping:
            return False
        with self._pending_lock:
            self._pending_handoffs.append(packet)
        return True

    def _take_packets(self):
        """Empty the handoff queue and return what it held."""
        with self._pending_lock:
            packets = list(self._pending_handoffs)
            self._pending_handoffs.clear()
        return packets

    def _hgather(self, pages):
        """The prefill side of a handoff: ``pages``' K/V of every layer,
        ``[L, len(pages), ps, H, D]`` each, gathered on the current
        stream (the replica's own) and, on the card, copied into pinned
        host memory, waited for by an event recorded after the copy.
        The event is made once: on a host loaded by the sibling
        replicas' workers, making one took milliseconds."""
        cache = self._cache
        with torch.no_grad():
            idx = torch.tensor(pages, dtype=torch.long, device=self._device)
            k = torch.index_select(cache.k_pool, 1, idx)
            v = torch.index_select(cache.v_pool, 1, idx)
            if self._device.type != "cuda":
                return k, v
            k_host = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
            v_host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            k_host.copy_(k, non_blocking=True)
            v_host.copy_(v, non_blocking=True)
            if self._copied is None:
                self._copied = torch.cuda.Event()
            self._copied.record()
            self._copied.synchronize()
        return k_host, v_host

    def _hscatter(self, k_host, v_host, pages):
        """The decode side: the host-staged K/V copied to the device on
        the current stream and written into ``pages`` of the pools with
        ``index_copy_``, in place (the captured steps hold the pools'
        addresses).  The copy is queued ahead of the next step on the
        same stream, so nothing waits for it here."""
        cache = self._cache
        with torch.no_grad():
            idx = torch.tensor(pages, dtype=torch.long, device=self._device)
            cache.k_pool.index_copy_(
                1, idx, k_host.to(self._device, non_blocking=True))
            cache.v_pool.index_copy_(
                1, idx, v_host.to(self._device, non_blocking=True))

    def _fail_all(self, exc):
        self._drain_pending()
        for pk in self._take_packets():
            pk.req.fail(exc)
        hol = self._take_hol()
        if hol is not None:
            req, cached_pages, _ = hol
            if cached_pages:
                # the worker thread, or the worker provably dead
                self._cache.release_prefix(cached_pages)
            req.fail(exc)
        if self._owns_queue:
            # a shared queue holds the sibling replicas' work too
            self._queue.drain_remaining(lambda r: exc)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._retire(i, error=exc)

    def evict_inflight(self):
        """Harvest every in-flight sequence for replay elsewhere: clear
        the slots and the parked head-of-line entry, free their pages and
        pinned prefix references, and return the (unfailed) requests —
        futures untouched, journals intact; :meth:`resubmit` re-admits
        each.  The worker must be dead or stopped (or never started):
        :meth:`evict_if_dead` holds that proof."""
        harvested = []
        # queued pin releases apply now; staged packets are harvestable
        # work (their KV copies go, their journals replay anywhere)
        self._drain_pending()
        harvested += [pk.req for pk in self._take_packets()
                      if not pk.req.done()]
        hol = self._take_hol()
        if hol is not None:
            req, cached_pages, _ = hol
            if cached_pages:
                self._cache.release_prefix(cached_pages)
            if not req.done():
                harvested.append(req)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._slots[i] = None
            self._tables[i] = 0
            self._cache.free(slot.pages)
            if not slot.req.done():
                harvested.append(slot.req)
        _active_slots.set(0)
        return harvested

    def evict_if_dead(self):
        """:meth:`evict_inflight` under the dead-worker proof (the
        worker's life lock serializes the aliveness check with any
        restart).  Returns None (no-op) while the worker is alive."""
        with self._worker.life_lock:
            if self._worker.alive:
                return None
            return self.evict_inflight()

    def idle(self):
        """No active sequence, no parked head-of-line request and no
        handoff packet waiting to be seated."""
        return (self._active_count() == 0 and self._hol is None
                and not self._pending_handoffs)

    def _serve_loop(self):
        if self._stream is None:
            return self._serve()
        with torch.cuda.stream(self._stream):
            return self._serve()

    def _serve(self):
        # (BaseException escaping this loop is the death path: the
        # RestartableWorker choke counts and reports it.)
        self._note_ts = time.perf_counter()
        self._note_retired = self._retired_total
        while True:
            # queued pin releases first: the pages they free may be what
            # this iteration's admission needs
            self._drain_pending()
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
                                              and self._hol is None
                                              and not self._pending_handoffs)):
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
        if not self._admit_handoffs():
            return                 # a staged packet waits for pages
        while self._active_count() < cfg.max_active:
            if self._worker.stopping and not self._drain:
                return
            hol = self._take_hol()
            if hol is not None:
                req, cached_pages, hashes = hol
            else:
                # the pool's gate applies to shared-queue pulls only: a
                # parked head-of-line request already belongs here
                if self._gate is not None and not self._gate():
                    if not self._active_count():
                        time.sleep(0.002)  # don't spin while gated out
                    return
                req = self._queue.get(
                    timeout=0.0 if self._active_count() else 0.05,
                    accept=self._claim)
                cached_pages, hashes = [], None
                if (req is not None
                        and req.affinity == self._replica_index):
                    _affinity_honored.inc()
            if req is None:
                return
            if req.cancelled or req.expired():
                if cached_pages:
                    cache.release_prefix(cached_pages)
                if req.cancelled:
                    _cancelled.inc()
                    req.fail(ServingCancelled(
                        "request cancelled before decode started"))
                else:
                    _expired.inc()
                    req.fail(ServingTimeout(
                        "deadline expired after %.3fs in decode queue"
                        % (time.perf_counter() - req.enqueue_ts)))
                self._completed += 1
                continue
            need = cache.pages_for(req.prompt_len + req.max_new_tokens)
            if cfg.prefix_cache and hashes is None:
                # probe ONCE, before the fresh alloc: hits shrink the
                # fresh reservation and stay pinned (a re-parked request
                # carries its probe result)
                cached_pages, hashes = cache.lookup_prefix(req.prompt)
            pages = cache.alloc(need - len(cached_pages))
            if pages is None:
                # pinned hit pages are not in free_pages: count them
                # toward what this reservation can ever assemble
                if (not self._active_count()
                        and need > cache.free_pages + len(cached_pages)):
                    # nothing will ever free enough: the reservation is
                    # larger than the whole (idle) pool
                    if cached_pages:
                        cache.release_prefix(cached_pages)
                    req.fail(ServingError(
                        "sequence needs %d pages but the pool has %d "
                        "usable; raise num_pages or shrink the request"
                        % (need, cache.free_pages)))
                    self._completed += 1
                    continue
                # pool exhausted: hold the head (FIFO) until a retirement
                # frees its reservation
                self._park_hol(req, cached_pages, hashes)
                return
            idx = self._place(req, cached_pages + pages,
                              len(cached_pages) * cfg.page_size, hashes)
            if not self._use_chunks:
                self._prefill(idx)

    def _admit_handoffs(self):
        """Seat injected handoff packets (sequences a prefill replica
        already prefilled) ahead of fresh queue work.  False when a
        packet waits for pages: fresh admission waits too, the packet
        being this replica's head of line (it holds host copies only,
        so waiting holds no pool pages)."""
        cache = self._cache
        while self._active_count() < self.config.max_active:
            with self._pending_lock:
                packet = (self._pending_handoffs[0]
                          if self._pending_handoffs else None)
            if packet is None:
                return True
            req = packet.req
            if req.cancelled or req.expired():
                with self._pending_lock:
                    self._pending_handoffs.popleft()
                if req.cancelled:
                    _cancelled.inc()
                    req.fail(ServingCancelled(
                        "request cancelled during prefill->decode "
                        "handoff"))
                else:
                    _expired.inc()
                    _expired_mid_decode.inc()
                    req.fail(ServingTimeout(
                        "deadline expired during prefill->decode "
                        "handoff"))
                self._completed += 1
                continue
            need = cache.pages_for(req.prompt_len + req.max_new_tokens)
            if need > cache.num_pages - 1:
                with self._pending_lock:
                    self._pending_handoffs.popleft()
                req.fail(ServingError(
                    "handed-off sequence needs %d pages but the pool "
                    "has %d" % (need, cache.num_pages - 1)))
                self._completed += 1
                continue
            pages = cache.alloc(need)
            if pages is None:
                return False
            with self._pending_lock:
                self._pending_handoffs.popleft()
            self._seat_handoff(packet, pages)
        return not self._pending_handoffs

    def _seat_handoff(self, packet, pages):
        """Land one packet: its K/V written into our freshly reserved
        pages, the slot seated already DECODING with the origin's first
        token (journaled there), the prompt's full pages registered
        here."""
        req = packet.req
        t0 = time.perf_counter()
        self._hscatter(packet.k_host, packet.v_host, pages[:packet.n_pages])
        _observe_stage("scatter", t0)
        idx = self._slots.index(None)
        slot = _Slot(req, pages, prefill_pos=req.prompt_len,
                     hashes=packet.hashes)
        slot.kv_len = packet.kv_len
        slot.generated.append(packet.first)
        self._slots[idx] = slot
        self._tables[idx] = self._cache.table_row(pages)
        if self.config.prefix_cache and packet.hashes:
            # the next turn's prefix probe must find the prompt in the
            # replica that serves the decode
            for pi in range(min(packet.kv_len // self.config.page_size,
                                len(packet.hashes), len(pages))):
                self._cache.register_prefix(packet.hashes, pi, pages[pi])
        _handoff_injected.inc()
        _active_slots.set(self._active_count())
        tel = self._telemetry
        if tel.recording:
            tel.emit({
                "type": "decode_handoff", "ts": time.time(),
                "source": "serving", "seq": req.seq, "leg": "inject",
                "origin": packet.origin, "dest": self._replica_index,
                "pages": packet.n_pages, "kv_len": packet.kv_len,
            })
        self._finish_if_done(idx)

    def _place(self, req, pages, cached_tokens=0, hashes=None):
        """Seat one admitted request in a free slot in the PREFILLING
        state and return the slot's index: pages are reserved (the first
        ``cached_tokens`` tokens' pages already hold a shared prompt
        prefix), but no model compute happens here."""
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
        self._slots[idx] = _Slot(req, pages, cached_tokens, hashes)
        self._tables[idx] = self._cache.table_row(pages)
        _active_slots.set(self._active_count())
        return idx

    @staticmethod
    def _consult_faults(requests):
        """The serving-dispatch fault choke point (testing.faults)."""
        serve_fault = _resilience._serve_fault
        if serve_fault is not None:
            serve_fault(requests)

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
            self._consult_faults([req])
            with self._telemetry.timed("serving.decode.prefill",
                                       bucket=bucket, rows=plen,
                                       seq=req.seq), torch.no_grad():
                logits, greedy = self._run_step(
                    ("prefill", bucket), _pack(tokens, plen, page_vec))
                first = int(_sample_tokens(
                    greedy, logits[None], np.array([temp]),
                    np.array([seed]), np.array([plen]), self._top_k)[0])
        except Exception as exc:  # noqa: BLE001 — worker must survive
            self._retire(idx, error=exc)
            self._record(ok=False)
            return
        except BaseException:
            self._died_mid_prefill(idx)
            raise
        done = time.perf_counter()
        _prefill_timer.observe(done - t0)
        self._record(ok=True)
        tel = self._telemetry
        if tel.span_active() and req.trace is not None:
            tel.record_span(
                "serving.execute", prefill_wall, done - t0,
                tags=req.trace.child().tags(phase="prefill", bucket=bucket,
                                            rows=plen))
        if cfg.kv_guard and self._guard_pages(
                [idx] * len(page_vec), page_vec, phase="prefill"):
            return
        slot.prefill_pos = slot.kv_len = plen
        _prefills.inc()
        _prefill_tokens.inc(plen)
        self._accept_first(idx, first, done)

    def _record(self, ok):
        """A dispatch's outcome on the pool's breaker, where given."""
        if self._breaker is not None:
            if ok:
                self._breaker.record_success()
            else:
                self._breaker.record_fatal()

    def _died_mid_prefill(self, idx):
        """The worker is being killed inside a prefill dispatch.  Alone,
        the sequence fails typed (the engine is sick, the request was
        fine) before the death propagates.  In a pool
        (``evict_on_death``) the slot stays as it is: a prefill writes
        only pages it has not yet published to the prefix index, so the
        pool harvests the slot (its pages freed) and a sibling
        re-prefills the sequence from its journal."""
        if not self._evict_on_death:
            self._retire(idx, error=ServingDegraded(
                "decode worker died mid-prefill; request aborted"))

    def _accept_first(self, idx, first, done):
        """The final prefill's sample is the sequence's first token."""
        slot = self._slots[idx]
        req = slot.req
        slot.generated.append(first)
        req.journal.accepted.append(first)
        req.token_times.append(time.perf_counter())
        _ttft_hist.observe(done - req.enqueue_ts)
        _tokens.inc()
        if not self._finish_if_done(idx):
            self._maybe_handoff(idx)

    def _maybe_handoff(self, idx):
        """Roles, prefill side: a freshly prefilled, unfinished sequence
        leaves for a decode replica.  Its pages are staged on the host,
        its seat released (the full prompt pages stay indexed here at
        refcount 0, so the next turn's probe still finds this replica
        warm) and the packet handed to ``on_handoff``; a handoff nobody
        took fails the request with ``ServingDegraded``.  Returns True
        when the slot left."""
        if self._role != "prefill" or self._on_handoff is None:
            return False
        slot = self._slots[idx]
        req = slot.req
        n_pages = self._cache.pages_for(slot.kv_len)
        t0 = time.perf_counter()
        k_host, v_host = self._hgather(slot.pages[:n_pages])
        _observe_stage("gather", t0)
        packet = HandoffPacket(
            req, k_host, v_host, n_pages=n_pages, kv_len=slot.kv_len,
            hashes=slot.hashes, origin=self._replica_index,
            first=slot.generated[-1])
        req.handoff_origin = self._replica_index
        self._slots[idx] = None
        self._tables[idx] = 0
        self._cache.free(slot.pages)
        _active_slots.set(self._active_count())
        _handoff_packets.inc()
        _handoff_pages.inc(n_pages)
        _handoff_bytes.inc(k_host.nbytes + v_host.nbytes)
        tel = self._telemetry
        if tel.recording:
            tel.emit({
                "type": "decode_handoff", "ts": time.time(),
                "source": "serving", "seq": req.seq, "leg": "export",
                "origin": self._replica_index, "pages": n_pages,
                "kv_len": slot.kv_len,
            })
        try:
            ok = self._on_handoff(packet)
        except Exception as exc:  # noqa: BLE001 — worker must survive
            ok, why = False, ": " + repr(exc)[:200]
        else:
            why = ""
        if not ok and not req.done():
            _handoff_failed.inc()
            req.fail(ServingDegraded(
                "prefill->decode KV handoff failed" + why))
            self._completed += 1
        return True

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
        so far (shared prefix pages included), register the full pages
        it completed, and — on the final chunk — sample the first
        token."""
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
        n_own = max(0, min(width // ps, n_prompt_pages - p0))
        chunk_vec[:n_own] = slot.pages[p0:p0 + n_own]
        temp, seed = self._sampling_params(req)
        t0 = time.perf_counter()
        chunk_wall = time.time()
        try:
            self._consult_faults([req])
            with self._telemetry.timed("serving.decode.prefill",
                                       bucket=width, rows=valid,
                                       start=start, seq=req.seq), \
                    torch.no_grad():
                logits, greedy = self._run_step(
                    ("chunk", width),
                    _pack(tokens, start, valid, chunk_vec, self._tables[idx]))
                # the first generated token sits at absolute position
                # start + valid; only the final chunk's sample is used
                first = int(_sample_tokens(
                    greedy, logits[None], np.array([temp]),
                    np.array([seed]), np.array([start + valid]),
                    self._top_k)[0])
        except Exception as exc:  # noqa: BLE001 — worker must survive
            self._retire(idx, error=exc)
            self._record(ok=False)
            return
        except BaseException:
            self._died_mid_prefill(idx)
            raise
        done = time.perf_counter()
        _prefill_timer.observe(done - t0)
        self._record(ok=True)
        tel = self._telemetry
        if tel.span_active() and req.trace is not None:
            tel.record_span(
                "serving.execute", chunk_wall, done - t0,
                tags=req.trace.child().tags(phase="prefill", bucket=width,
                                            rows=valid, start=start))
        if cfg.kv_guard and self._guard_pages(
                [idx] * len(chunk_vec), chunk_vec, phase="prefill"):
            return
        slot.prefill_pos = start + valid
        slot.kv_len = slot.prefill_pos
        _prefills.inc()
        _prefill_tokens.inc(valid)
        if cfg.prefix_cache and slot.hashes:
            # publish every full page this chunk completed: its content
            # is immutable from now on (decode appends past the prompt)
            for pi in range(p0, min((start + valid) // ps,
                                    len(slot.hashes))):
                self._cache.register_prefix(slot.hashes, pi, slot.pages[pi])
        if slot.prefill_pos >= req.prompt_len:
            self._accept_first(idx, first, done)

    def _guard_pages(self, owners, page_vec, phase):
        """KV integrity sweep over ``page_vec`` (``owners[j]`` = the slot
        that wrote entry j; scratch-page entries are skipped).  A
        non-finite page fails its owning slot typed (``KVCorruption``)
        and scrubs the bad pages in place, so the poison cannot outlive
        the sequence into a future page owner or a prefix hit.  Returns
        the set of tripped slot indices (empty = clean)."""
        with torch.no_grad():
            ok = self._run_step(("kvguard", len(page_vec)),
                                page_vec).cpu().numpy()
        bad = [j for j in range(len(page_vec))
               if page_vec[j] and not ok[j]]
        if not bad:
            return set()
        tripped = {}
        for j in bad:
            tripped.setdefault(owners[j], []).append(int(page_vec[j]))
        for idx, pages in tripped.items():
            slot = self._slots[idx]
            _kv_guard_trips.inc()
            self._retire(idx, error=KVCorruption(
                "non-finite KV write in page(s) %s during %s (seq %s, "
                "%d/%d tokens); sequence failed, pages scrubbed"
                % (pages, phase, slot.req.seq, len(slot.generated),
                   slot.req.max_new_tokens)))
            # after the retire's free the pages are rc=0 (the guard only
            # trips on privately written pages): zero them and drop any
            # index entries before the allocator reuses them
            self._cache.scrub_pages(pages)
        return set(tripped)

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
        S = cfg.num_slots
        tokens = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        kv_lens = np.zeros((S,), np.int32)
        seeds = np.zeros((S,), np.uint32)
        temps = np.zeros((S,), np.float32)
        for i, slot in active:
            tokens[i] = slot.generated[-1]   # feed the last sampled token
            positions[i] = slot.kv_len       # ... at the next cache index
            kv_lens[i] = slot.kv_len + 1     # visible kv incl. this token
            temps[i], seeds[i] = self._sampling_params(slot.req)
        # the decode step writes EVERY slot's token k/v at
        # page_tables[s, positions[s] // ps]; a PREFILLING slot's row
        # already points at its real (possibly shared prefix) pages, so
        # its dispatch row must aim at scratch like any other
        # non-decoding slot, or the write corrupts position 0 of a cache
        tables = self._tables
        masked = [i for i, s in enumerate(self._slots)
                  if s is not None and s.prefilling]
        if masked:
            tables = self._tables.copy()
            tables[masked] = 0
        t0 = time.perf_counter()
        try:
            self._consult_faults([s.req for _, s in active])
            with self._telemetry.timed("serving.decode.step",
                                       active=len(active)), torch.no_grad():
                logits, greedy = self._run_step(
                    ("decode",), _pack(tokens, positions, kv_lens, tables))
                # kv_lens = the sampled token's absolute position
                sampled = _sample_tokens(greedy, logits, temps, seeds,
                                         kv_lens, self._top_k)
        except Exception as exc:  # noqa: BLE001 — worker must survive
            # a failed step may have written part of its KV in place:
            # not replayable, so the active sequences fail typed
            for i, _ in active:
                self._retire(i, error=exc)
            self._record(ok=False)
            return
        self._record(ok=True)
        step_s = time.perf_counter() - t0
        _decode_timer.observe(step_s)
        _step_hist.observe(step_s)
        tripped = ()
        if cfg.kv_guard:
            # sweep each active slot's TAIL page — the one this step's
            # token write landed in (position = pre-step kv_len)
            guard_vec = np.zeros((S,), np.int32)
            for i, slot in active:
                guard_vec[i] = slot.pages[slot.kv_len // cfg.page_size]
            tripped = self._guard_pages(list(range(S)), guard_vec,
                                        phase="decode")
        now = time.perf_counter()
        for i, slot in active:
            if i in tripped:
                continue           # retired typed by the guard
            slot.kv_len += 1
            tok = int(sampled[i])
            slot.generated.append(tok)
            slot.req.journal.accepted.append(tok)
            slot.req.token_times.append(now)
        _steps.inc()
        _tokens.inc(len(active) - len(tripped))
        for i, _ in active:
            if self._slots[i] is not None:
                self._finish_if_done(i)
        _active_slots.set(self._active_count())
        self._cache.publish_gauges(
            sum(s.kv_len for s in self._slots if s is not None))

    def _retire(self, idx, error=None):
        slot = self._slots[idx]
        self._slots[idx] = None
        self._tables[idx] = 0
        if (error is None and self._sessions is not None
                and slot.req.session is not None):
            # pin BEFORE the free below: every parked page stays rc >= 1
            # throughout, so nothing can evict it in between
            self._park_session(slot)
        self._cache.free(slot.pages)
        self._completed += 1
        if error is None:
            # only SERVED sequences feed the rate EMA
            self._retired_total += 1
        req = slot.req
        if error is not None:
            req.fail(error)
        else:
            # the journal, not the slot: after a resubmit the slot holds
            # this incarnation's tokens, the journal all of them
            req.complete(req.journal.tokens())
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

    def _park_session(self, slot):
        """Park a conversational turn that retired without error (worker
        thread, called by :meth:`_retire` before the slot's pages are
        freed): register the prompt's full pages in the prefix index,
        take a session pin on them, and record the conversation in the
        shared store.

        Only the pages whose every row a prefill chunk wrote are parked:
        the first ``prompt_len // page_size``.  The JAX package parks
        the whole history's full pages, the generated tokens' too, but
        on the card a decode step computes its K/V through other kernels
        (B4's split walk against B5, a ``[num_slots, d]`` GEMM against a
        ``[C, d]`` one) and writes other bits than a prefill of the same
        tokens (ROADMAP F-13), so a warm turn that mapped them would not
        be bitwise a cold re-prefill.  The next turn prefills the last
        turn's generated tokens again.

        Roles: a turn handed off here from a prefill replica stays
        sticky to its ORIGIN, where the next turn's prefill (and prefix
        probe) runs; no pin is taken here, the origin's warmth being its
        registered prompt pages at refcount 0."""
        req = slot.req
        history = req.journal.resume_prompt()
        origin = req.handoff_origin
        sticky = origin if origin is not None else self._replica_index
        pinned = []
        if sticky == self._replica_index:
            ps = self.config.page_size
            hashes = self._cache.prefix_hashes(history)
            # registered as they were written or mapped (idempotent
            # here); the decode-written pages stay private (F-13)
            n_full = min(slot.prompt_len // ps, len(slot.pages),
                         len(hashes))
            for pi in range(n_full):
                self._cache.register_prefix(hashes, pi, slot.pages[pi])
            pinned = self._cache.pin_prefix(history, limit=n_full)
            _session_parked_pages.inc(len(pinned))
        self._sessions.park(req.session, replica=sticky,
                            history_len=len(history), pages=pinned,
                            release=self.release_session_pins)
