"""Paged KV cache: a preallocated page pool + per-sequence page tables.

Counterpart of ``paddle_tpu/serving/kv_cache.py`` (vLLM/PagedAttention,
Kwon et al. SOSP'23): keys and values live in fixed-size PAGES of one
pool per layer, ``[L, num_pages, page_size, H, D]``, preallocated once
on the device, and each sequence owns an ordered list of page ids (its
page table).  Admission allocates, retirement frees, and the pool's
occupancy — not a worst-case rectangle — bounds how many sequences
decode concurrently.

Allocation discipline (decode_scheduler.py is the only caller):

* **allocate-on-admit**: a sequence reserves ``ceil((prompt_len +
  max_new_tokens) / page_size)`` pages up front, so decode never runs
  out mid-flight.  The reserved-but-unwritten share is published as the
  ``serving.decode.kv_fragmentation`` gauge.
* **free-on-retire**: the whole reservation returns when the sequence
  finishes or sheds.  Freed pages are not scrubbed — every read masks by
  the owning sequence's ``kv_lens``.
* **page 0 is the scratch page**: never allocated.  Inactive decode
  slots and pad-tail chunk pages aim their writes at it.

**Prefix caching** layers block-level KV sharing on top (the vLLM move of
treating the page pool as a content-addressed cache):

* every page is REFCOUNTED; ``alloc`` hands out rc=1 pages, a prefix hit
  increfs, ``free`` decrefs, and a page is reusable only at rc=0.
* a **content-hash index** maps a chain hash — sha1 over whole page-size
  token blocks, each link folding in the previous one, so a hit certifies
  the entire prefix — to the page holding that block's K/V.  Only FULL
  pages are indexed: a full prefix page is immutable while shared, so
  copy-on-write is never needed.
* ``lookup_prefix`` walks a prompt's leading full pages through the index
  and increfs the hits (capped at ``len - 1`` tokens: the last token
  always prefills); ``register_prefix`` publishes freshly written pages.
* rc=0 pages whose content is indexed park in an **LRU** list and keep
  answering hits until ``alloc`` evicts them, after the plain free list
  runs dry (``serving.decode.kv_evictions``).

Reuse shows on ``serving.decode.kv_hit_pages`` / ``kv_miss_pages``
(probe outcomes), ``kv_evictions``, and the gauges ``kv_shared_pages``
(pages in 2+ page tables) and ``kv_cached_pages`` (the rc=0 LRU).

The pools are torch tensors that the model's steps update IN PLACE, and
the scheduler's captured CUDA graphs hold their addresses: nothing ever
rebinds ``k_pool``/``v_pool`` (``reset_pools`` and ``scrub_pages`` zero
in place).  The cache object holds them plus the host-side allocator
state and the ``serving.decode.kv_*`` gauges.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from .. import observability as _obs
from .errors import ServingError

__all__ = ["PagedKVCache", "torch_dtype", "write_prompt_kv"]

_pages_total = _obs.gauge("serving.decode.kv_pages_total")
_pages_used = _obs.gauge("serving.decode.kv_pages_used")
_occupancy = _obs.gauge("serving.decode.kv_occupancy")
_fragmentation = _obs.gauge("serving.decode.kv_fragmentation")
_hit_pages = _obs.counter("serving.decode.kv_hit_pages")
_miss_pages = _obs.counter("serving.decode.kv_miss_pages")
_evictions = _obs.counter("serving.decode.kv_evictions")
_shared_pages = _obs.gauge("serving.decode.kv_shared_pages")
_cached_pages = _obs.gauge("serving.decode.kv_cached_pages")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(dtype):
    """A pool dtype given as a string (``"float32"``, ``"bfloat16"``,
    ``"float16"``) or a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ServingError("unsupported kv dtype %r (know %s)"
                           % (dtype, sorted(_DTYPES))) from None


def write_prompt_kv(k_pool, v_pool, k_new, v_new, pages):
    """Scatter a prefilled prompt's whole-page blocks into the pools, IN
    PLACE (the legacy whole-prompt prefill's write).

    k_new/v_new: ``[L, T, H, D]`` with ``T % page_size == 0`` (the prefill
    bucket is a page multiple); ``pages``: ``[T // page_size]`` int page
    ids on the pools' device — entries past the sequence's real need
    point at the scratch page 0, so the scatter's shape is fixed per
    bucket (which of the colliding scratch writes lands is unspecified;
    nothing reads the scratch page).  Returns ``(k_pool, v_pool)``."""
    L, T, H, D = k_new.shape
    ps = k_pool.shape[2]
    n = T // ps
    idx = pages.long()
    k_pool.index_copy_(1, idx, k_new.reshape(L, n, ps, H, D).to(k_pool.dtype))
    v_pool.index_copy_(1, idx, v_new.reshape(L, n, ps, H, D).to(v_pool.dtype))
    return k_pool, v_pool


def write_token_kv(k_pool, v_pool, k_tok, v_tok, pages, offsets):
    """Scatter one decode step's token k/v of each slot into the pools,
    IN PLACE.

    k_tok/v_tok: ``[L, S, H, D]``; ``pages``/``offsets``: ``[S]`` int
    tensors on the pools' device — slot s's token lands at
    ``pool[:, pages[s], offsets[s]]``.  Inactive slots aim at the scratch
    page (which of their colliding writes lands is unspecified; nothing
    reads it).  Returns ``(k_pool, v_pool)``."""
    layers = torch.arange(k_pool.shape[0], device=k_pool.device)
    idx = (layers[:, None], pages.long()[None], offsets.long()[None])
    k_pool.index_put_(idx, k_tok.to(k_pool.dtype))
    v_pool.index_put_(idx, v_tok.to(v_pool.dtype))
    return k_pool, v_pool


class PagedKVCache:
    """Preallocated paged pools on ``device`` + the refcounting allocator.

    Parameters
    ----------
    num_layers / num_heads / head_dim: model dims; the pools are
        ``[L, num_pages, page_size, H, D]`` (k and v).
    num_pages: pool size INCLUDING the reserved scratch page 0.
    page_size: tokens per page.
    max_seq_len: longest sequence the runtime will hold; fixes the
        per-slot page-table width ``max_pages_per_seq``.
    dtype: pool dtype (bf16 halves the pool's memory; f32 default).
    device: where the pools live.
    """

    def __init__(self, num_layers, num_pages, page_size, num_heads,
                 head_dim, max_seq_len, dtype="float32", device="cpu"):
        if num_pages < 2:
            raise ServingError(
                "num_pages must be >= 2 (page 0 is the reserved scratch "
                "page), got %d" % num_pages)
        if page_size < 1 or max_seq_len < 1:
            raise ServingError("page_size and max_seq_len must be >= 1")
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.max_seq_len = int(max_seq_len)
        self.max_pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.dtype = torch_dtype(dtype)
        self.device = torch.device(device)
        shape = (self.num_layers, self.num_pages, self.page_size,
                 self.num_heads, self.head_dim)
        self.k_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=self.dtype, device=self.device)
        # page 0 = scratch; everything else starts free
        self._free = collections.deque(range(1, self.num_pages))
        self._used = 0
        self._rc = [0] * self.num_pages
        # prefix-cache state: chain hash -> page id, its inverse, and the
        # rc=0-but-still-indexed pages in least-recently-used order
        self._index = {}
        self._hash_of_page = {}
        self._lru = collections.OrderedDict()
        # this instance's probe accounting (the counters are process-wide)
        self._hits = self._misses = self._evicted = 0
        # rc >= 2 count, kept incrementally (read on every admission)
        self._shared = 0
        # the owning scheduler's () -> live seq ids; reset_pools consults
        # it so nothing zeroes pages under a running sequence unforced
        self.live_seqs = None
        _pages_total.set(self.num_pages - 1)
        self._publish(0)

    def reset_pools(self, force=False):
        """Zero both pools IN PLACE (allocator state untouched; the
        captured steps keep their addresses) and flush the prefix index,
        whose entries describe contents that no longer exist.

        Zeroing pages under sequences that still decode from them would
        silently corrupt their output, so when the owning scheduler has
        installed a ``live_seqs`` callback and it reports active
        sequences (or, with no callback, when any page is still rc >= 1),
        this raises a typed :class:`ServingError` listing them unless
        ``force=True`` (a recovery path that already failed its
        sequences)."""
        if not force:
            live = (sorted(self.live_seqs())
                    if self.live_seqs is not None else None)
            if live:
                raise ServingError(
                    "reset_pools would zero KV under %d live sequence(s) "
                    "(seq %s); retire or evict them first, or pass "
                    "force=True from a recovery path"
                    % (len(live), ", ".join(str(s) for s in live)))
            if live is None and self._used:
                raise ServingError(
                    "reset_pools would zero %d allocated page(s) with no "
                    "live_seqs callback installed; pass force=True if "
                    "their owners are already failed" % self._used)
        with torch.no_grad():
            self.k_pool.zero_()
            self.v_pool.zero_()
        self._index.clear()
        self._hash_of_page.clear()
        for p in self._lru:
            self._free.append(p)
        self._lru.clear()
        _cached_pages.set(0)

    def release_pools(self):
        """Drop both pools (their owner has stopped, and nothing replays
        a step that writes them): the allocator's books stay readable,
        the device memory goes back to the caching allocator."""
        self.k_pool = self.v_pool = None

    def scrub_pages(self, pages):
        """Zero the given pages in both pools, IN PLACE, and drop their
        prefix-index entries — the hygiene step after the KV integrity
        sweep trips.  Unlike normal retirement (where stale values are
        unreachable because reads mask by ``kv_lens``), a NON-FINITE
        stale value is reachable arithmetic (``0 * nan = nan`` in a
        masked product) and would poison every future owner of the
        page.  Pages still shared (rc >= 2) are skipped: they predate the
        corrupt write and other readers depend on them."""
        scrub = [int(p) for p in pages if p != 0 and self._rc[p] <= 1]
        if not scrub:
            return
        idx = torch.as_tensor(scrub, dtype=torch.long, device=self.device)
        with torch.no_grad():
            self.k_pool.index_fill_(1, idx, 0)
            self.v_pool.index_fill_(1, idx, 0)
        for p in scrub:
            h = self._hash_of_page.pop(p, None)
            if h is not None:
                self._index.pop(h, None)
            if p in self._lru:
                del self._lru[p]
                self._free.append(p)
        _cached_pages.set(len(self._lru))

    # -- allocator -----------------------------------------------------------
    @property
    def free_pages(self):
        """Pages an ``alloc`` could hand out right now: the plain free
        list plus the rc=0 indexed pages eviction would reclaim."""
        return len(self._free) + len(self._lru)

    @property
    def used_pages(self):
        """Pages referenced by at least one live page table (rc >= 1)."""
        return self._used

    @property
    def cached_pages(self):
        """rc=0 pages retained for prefix reuse (evictable)."""
        return len(self._lru)

    @property
    def shared_pages(self):
        """Pages live in two or more page tables right now."""
        return self._shared

    def pages_for(self, tokens):
        """Pages a ``tokens``-long sequence reserves (ceil)."""
        return -(-int(tokens) // self.page_size)

    def alloc(self, n):
        """Reserve ``n`` fresh rc=1 pages; returns their ids or None when
        the pool can't cover the reservation (the caller queues the
        sequence).  The plain free list goes first; only then are
        least-recently-used rc=0 prefix pages evicted (index entries
        dropped, ``kv_evictions`` counted)."""
        n = int(n)
        if n > self.free_pages:
            return None
        pages = []
        for _ in range(n):
            if self._free:
                p = self._free.popleft()
            else:
                p, _ = self._lru.popitem(last=False)  # least recently used
                del self._index[self._hash_of_page.pop(p)]
                self._evicted += 1
                _evictions.inc()
            self._rc[p] = 1
            pages.append(p)
        self._used += n
        _cached_pages.set(len(self._lru))
        return pages

    def free(self, pages):
        """Drop one reference per page of a retired sequence's
        reservation.  A page at rc=0 returns to the free list — unless
        its content is indexed, in which case it parks at the
        most-recently-used end of the LRU and keeps answering hits until
        evicted."""
        dropped_shared = 0
        for p in pages:
            if p == 0:
                raise ServingError("page 0 is the scratch page; never owned")
            rc = self._rc[p]
            if rc < 1:
                raise ServingError("double free of page %d" % p)
            if rc == 2:
                dropped_shared += 1
                self._shared -= 1
            self._rc[p] = rc - 1
            if rc == 1:
                self._used -= 1
                if p in self._hash_of_page:
                    self._lru[p] = None
                else:
                    self._free.append(p)
        if dropped_shared:
            _shared_pages.set(self._shared)
        _cached_pages.set(len(self._lru))

    # -- prefix cache --------------------------------------------------------
    @staticmethod
    def _chain_hashes(tokens, page_size):
        """Chain hash per FULL page of ``tokens``: link i certifies token
        blocks ``0 .. i`` (each digest folds in the previous), so an
        index hit on link i proves the whole prefix matches.  The JAX
        package's hashes, byte for byte."""
        toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
        hashes = []
        h = b"kv-prefix-v1"
        for i in range(len(toks) // page_size):
            block = toks[i * page_size:(i + 1) * page_size]
            h = hashlib.sha1(h + block.tobytes()).digest()
            hashes.append(h)
        return hashes

    def prefix_hashes(self, tokens):
        """One chain hash per full page of ``tokens``."""
        return self._chain_hashes(tokens, self.page_size)

    def _incref(self, pages):
        for p in pages:
            if self._rc[p] == 0:       # parked in the LRU: revive
                del self._lru[p]
                self._used += 1
            elif self._rc[p] == 1:     # 1 -> 2: newly shared
                self._shared += 1
            self._rc[p] += 1
        _shared_pages.set(self._shared)
        _cached_pages.set(len(self._lru))

    def _indexed_run(self, hashes, n):
        """The pages of the leading indexed links among ``hashes[:n]``."""
        pages = []
        for h in hashes[:n]:
            p = self._index.get(h)
            if p is None:
                break
            pages.append(p)
        return pages

    def lookup_prefix(self, tokens):
        """Probe the index for ``tokens``' longest cached page prefix.

        Returns ``(pages, hashes)``: ``hashes`` is the full chain (one
        per full page — pass it back to :meth:`register_prefix` as pages
        get written), ``pages`` the already-cached leading run, each
        INCREF'd (map them read-only; ``free`` drops the references at
        retirement).  Reuse is capped at ``len(tokens) - 1`` tokens so at
        least one token always goes through prefill — the last
        position's logits (the first sampled token) live in no cache."""
        hashes = self._chain_hashes(tokens, self.page_size)
        probed = min((len(tokens) - 1) // self.page_size, len(hashes))
        pages = self._indexed_run(hashes, probed)
        self._incref(pages)
        misses = probed - len(pages)
        self._hits += len(pages)
        self._misses += misses
        _hit_pages.inc(len(pages))
        _miss_pages.inc(misses)
        return pages, hashes

    def release_prefix(self, pages):
        """Undo a :meth:`lookup_prefix` whose admission could not finish
        (pool exhausted for the tail): drop the probe's references."""
        self.free(pages)

    def peek_hashes(self, hashes, limit=None):
        """How many LEADING links of ``hashes`` are indexed right now —
        read-only (no increfs, no hit/miss accounting, no LRU touch)."""
        n = len(hashes) if limit is None else min(int(limit), len(hashes))
        return len(self._indexed_run(hashes, n))

    def peek_prefix(self, tokens):
        """:meth:`peek_hashes` over ``tokens``' own chain, capped like
        :meth:`lookup_prefix` (at least one token always prefills)."""
        return self.peek_hashes(self._chain_hashes(tokens, self.page_size),
                                limit=(len(tokens) - 1) // self.page_size)

    def pin_prefix(self, tokens, limit=None):
        """Take one EXTRA reference on each indexed page of ``tokens``'
        leading chain, so LRU eviction cannot reclaim it until
        :meth:`free` drops the pin.  No hit/miss accounting and no
        ``len - 1`` cap.  Returns the pinned page ids."""
        hashes = self._chain_hashes(tokens, self.page_size)
        n = len(hashes) if limit is None else min(int(limit), len(hashes))
        pages = self._indexed_run(hashes, n)
        self._incref(pages)
        return pages

    def register_prefix(self, hashes, page_index, page):
        """Publish one freshly WRITTEN full page: ``page`` holds the K/V
        of token block ``page_index`` under ``hashes[page_index]``.
        First writer wins — a hash already indexed keeps its page and
        this one stays private (returns False)."""
        h = hashes[page_index]
        if h in self._index or page in self._hash_of_page:
            return False
        self._index[h] = page
        self._hash_of_page[page] = h
        return True

    def prefix_stats(self):
        """This cache's own snapshot (the registry counters sum across
        every cache in the process)."""
        return {
            "kv_hit_pages": self._hits,
            "kv_miss_pages": self._misses,
            "kv_evictions": self._evicted,
            "kv_shared_pages": self._shared,
            "kv_cached_pages": len(self._lru),
            "indexed_pages": len(self._index),
        }

    def stats(self):
        """Allocator snapshot with the leaked-refcount sweep: every
        non-scratch page must be in exactly one state — rc >= 1 (used),
        rc = 0 and parked in the LRU, or rc = 0 on the free list.
        ``rc_errors`` lists the pages that are not; ``rc_sum_matches``
        checks ``used_pages`` and ``shared_pages`` against the
        refcounts."""
        free = set(self._free)
        errors = []
        n_used = n_shared = 0
        for p in range(1, self.num_pages):
            rc = self._rc[p]
            in_free, in_lru = p in free, p in self._lru
            if rc < 0:
                errors.append((p, rc, "negative refcount"))
            elif rc > 0:
                n_used += 1
                n_shared += rc >= 2
                if in_free or in_lru:
                    errors.append((p, rc, "referenced page also in %s"
                                   % ("free list" if in_free else "LRU")))
            elif in_free and in_lru:
                errors.append((p, rc, "page in free list AND LRU"))
            elif not in_free and not in_lru:
                errors.append((p, rc, "leaked: rc=0 but in neither "
                               "free list nor LRU"))
        st = {
            "num_pages": self.num_pages,
            "used_pages": self._used,
            "free_pages": self.free_pages,
            "cached_pages": len(self._lru),
            "shared_pages": self._shared,
            "rc_errors": errors,
            "rc_sum_matches": (n_used == self._used
                               and n_shared == self._shared),
        }
        st.update(self.prefix_stats())
        return st

    # -- telemetry -----------------------------------------------------------
    def _publish(self, live_tokens):
        _pages_used.set(self._used)
        _occupancy.set(self.occupancy())
        _fragmentation.set(self.fragmentation(live_tokens))

    def publish_gauges(self, live_tokens):
        """Refresh occupancy/fragmentation gauges; the scheduler calls this
        once per iteration with the total live (written) token count."""
        self._publish(int(live_tokens))

    def fragmentation(self, live_tokens):
        """Reserved-but-unwritten share of the allocated capacity."""
        cap = self._used * self.page_size
        return max(0.0, 1.0 - int(live_tokens) / cap) if cap else 0.0

    def occupancy(self):
        usable = self.num_pages - 1
        return self._used / usable if usable else 0.0

    def table_row(self, pages):
        """A fixed-width ``[max_pages_per_seq]`` int32 page-table row for
        ``pages`` (tail entries -> scratch page 0)."""
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        row[:len(pages)] = pages
        return row
