"""Conversational sessions: cross-turn KV persistence over the pool.

Counterpart of ``paddle_tpu/serving/sessions.py``.  Multi-turn chat is
the largest serving workload: turn N+1's prompt is turn N's entire
history plus one utterance, yet a prefix-blind pool re-prefills the
whole history every turn and hits the prefix cache only when
least-loaded dispatch happens to land the request on the replica that
owns the pages.  Sessions make the reuse a CONTRACT instead of an
accident:

- **The token.**  ``generate(..., session="user-42")`` tags a request
  as one turn of a conversation.  When the sequence retires, the owning
  scheduler registers the finished history's prefill-written full KV
  pages in its prefix index and takes one extra refcount on the chain (a
  *session pin*, ``PagedKVCache.pin_prefix``) so LRU eviction can't
  reclaim them between turns, then records the conversation here.  The
  next turn — whose prompt IS the full history plus the new utterance (a
  warm turn must equal a cold re-prefill of that prompt, bitwise, so the
  prompt is the same either way) — probes the prefix cache as usual and
  maps the pinned pages instead of recomputing them.  The port pins only
  the pages a prefill chunk wrote (ROADMAP F-13): the pages a decode
  step wrote hold other bits than a prefill of the same tokens.

- **The store.**  :class:`SessionStore` is a TTL + capacity LRU map of
  session key -> :class:`SessionRecord` (owning replica, pinned pages,
  token history length).  Capacity eviction, TTL expiry (swept by the
  pool's decode gate), ``end_session()``, and ``clear()`` all release
  the record's pins through the owning scheduler's release queue — the
  cache allocator is worker-owned, so pins are dropped ON the worker (or
  directly once it is provably dead), never from an arbitrary caller
  thread.  Pins move host-side refcounts only; the pools on the card
  are never touched.

- **Affinity.**  The pool's dispatch consults the store first
  (session-sticky: route the turn to the replica that holds the pins),
  then the cross-replica chain-hash peek (longest-prefix-match), then
  least-loaded — see ``ReplicaPool._stamp_affinity``.  A session whose
  owner replica died simply falls back: the prompt carries the whole
  history, so the sibling cold-prefills it — the journal/replay
  semantics, at conversation granularity.  Nothing is ever lost with
  the store unavailable; only recompute is.

Keys are opaque.  The router namespaces them per (deployment, tenant)
via :func:`scoped_session` so two tenants can never collide on a
session id; the pool and solo scheduler use them verbatim.

Telemetry (always-counting registry cells): ``serving.session.parked``
/ ``resumed`` / ``expired`` / ``evicted`` / ``ended`` counters,
``serving.session.active`` / ``pinned_pages`` gauges.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import observability as _obs

__all__ = ["SessionRecord", "SessionStore", "scoped_session"]

_parked = _obs.counter("serving.session.parked")
_resumed = _obs.counter("serving.session.resumed")
_expired = _obs.counter("serving.session.expired")
_evicted = _obs.counter("serving.session.evicted")
_ended = _obs.counter("serving.session.ended")
_active_gauge = _obs.gauge("serving.session.active")
_pinned_gauge = _obs.gauge("serving.session.pinned_pages")

# separator for scoped keys: unit separator can't appear in validated
# deployment/tenant/session names, so scopes can't be forged by a
# crafted session id ("a/b" vs tenant "a" session "b")
_SCOPE_SEP = "\x1f"


def scoped_session(deployment, tenant, session):
    """Namespace a caller's session id per (deployment, tenant) — the
    router's collision guard: two tenants (or two deployments) using
    the same session id map to distinct store keys."""
    return _SCOPE_SEP.join((str(deployment), str(tenant or ""),
                            str(session)))


class SessionRecord:
    """One parked conversation: where its KV lives and what it covers.

    ``replica`` is the sticky dispatch target (the replica whose cache
    holds ``pages``); ``history_len`` the token length of the full
    conversation so far (prompt + generated of the last turn);
    ``pages`` the session-pinned page ids in that replica's cache;
    ``release`` the owning scheduler's pin-release enqueue (thread-safe,
    drains on its worker).  ``turns`` counts parks for observability.
    """

    __slots__ = ("key", "replica", "history_len", "pages", "release",
                 "turns", "created", "last_used")

    def __init__(self, key, replica, history_len, pages, release):
        self.key = key
        self.replica = int(replica)
        self.history_len = int(history_len)
        self.pages = list(pages)
        self.release = release
        self.turns = 1
        self.created = time.perf_counter()
        self.last_used = self.created

    def _drop_pins(self):
        pages, self.pages = self.pages, []
        if pages and self.release is not None:
            try:
                self.release(pages)
            except Exception:  # noqa: BLE001 — a dead scheduler's
                pass           # release must not break store upkeep


class SessionStore:
    """TTL + capacity LRU of live conversations; thread-safe.

    ``capacity`` bounds live sessions (least-recently-USED evicted
    first, pins released); ``ttl_s`` expires sessions idle longer than
    the window — :meth:`expire` is cheap and meant to be called from a
    periodic tick (the pool's supervisor loop), and every :meth:`get`
    lazily expires the record it is about to return.  All mutation
    happens under one lock; pin release runs OUTSIDE it (the release
    callbacks only enqueue onto the owning scheduler)."""

    def __init__(self, capacity=512, ttl_s=600.0):
        if capacity < 1:
            raise ValueError("session capacity must be >= 1")
        self.capacity = int(capacity)
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self._records = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self):
        with self._lock:
            return len(self._records)

    def _expired_locked(self, rec, now):
        return (self.ttl_s is not None
                and now - rec.last_used > self.ttl_s)

    def get(self, key, touch=True):
        """The live record for ``key`` or None; bumps the LRU (and the
        ``resumed`` counter) unless ``touch=False``.  A TTL-expired
        record is removed (pins released) instead of returned."""
        now = time.perf_counter()
        dead = None
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return None
            if self._expired_locked(rec, now):
                dead = self._records.pop(key)
            elif touch:
                rec.last_used = now
                self._records.move_to_end(key)
            self._publish_locked()
        if dead is not None:
            _expired.inc()
            dead._drop_pins()
            return None
        if touch:
            _resumed.inc()
        return rec

    def park(self, key, replica, history_len, pages, release):
        """Record (or refresh) a conversation after a turn retired:
        the NEW pins replace the old record's — a session's pages are
        re-pinned per turn against the retiring replica, so the stale
        pins (possibly on a different replica, if the conversation
        moved) must be dropped or they leak.  Evicts LRU records over
        capacity.  Returns the record."""
        rec = SessionRecord(key, replica, history_len, pages, release)
        evictees = []
        with self._lock:
            old = self._records.pop(key, None)
            if old is not None:
                rec.turns = old.turns + 1
                evictees.append(old)
            self._records[key] = rec
            while len(self._records) > self.capacity:
                _, lru = self._records.popitem(last=False)
                _evicted.inc()
                evictees.append(lru)
            self._publish_locked()
        for victim in evictees:
            victim._drop_pins()
        _parked.inc()
        return rec

    def end_session(self, key):
        """Explicitly finish a conversation: release its pins and drop
        the record.  Returns True when the session existed."""
        with self._lock:
            rec = self._records.pop(key, None)
            self._publish_locked()
        if rec is None:
            return False
        _ended.inc()
        rec._drop_pins()
        return True

    def expire(self, now=None):
        """TTL sweep: drop every idle-past-the-window session (pins
        released); returns how many expired.  Called from the pool's
        supervisor tick."""
        if self.ttl_s is None:
            return 0
        now = time.perf_counter() if now is None else now
        dead = []
        with self._lock:
            for key, rec in list(self._records.items()):
                if self._expired_locked(rec, now):
                    dead.append(self._records.pop(key))
            if dead:
                self._publish_locked()
        for rec in dead:
            _expired.inc()
            rec._drop_pins()
        return len(dead)

    def clear(self):
        """Drop every session (pins released) — the pool's stop path,
        so a cold-tier demotion can't leak pinned pages.  Returns how
        many sessions were dropped."""
        with self._lock:
            records = list(self._records.values())
            self._records.clear()
            self._publish_locked()
        for rec in records:
            rec._drop_pins()
        return len(records)

    def keys(self):
        with self._lock:
            return list(self._records)

    def stats(self):
        with self._lock:
            return {
                "active": len(self._records),
                "capacity": self.capacity,
                "ttl_s": self.ttl_s,
                "pinned_pages": sum(len(r.pages)
                                    for r in self._records.values()),
            }

    def _publish_locked(self):
        _active_gauge.set(len(self._records))
        _pinned_gauge.set(sum(len(r.pages)
                              for r in self._records.values()))
