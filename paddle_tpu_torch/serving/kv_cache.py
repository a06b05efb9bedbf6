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
* every page is **refcounted** (``alloc`` hands out rc=1, ``free``
  decrefs); the prefix index that shares pages between sequences is not
  ported yet.

The pools are torch tensors that the model's steps update IN PLACE; the
cache object holds them plus the host-side allocator state and the
``serving.decode.kv_*`` gauges.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .. import observability as _obs
from .errors import ServingError

__all__ = ["PagedKVCache", "torch_dtype", "write_prompt_kv"]

_pages_total = _obs.gauge("serving.decode.kv_pages_total")
_pages_used = _obs.gauge("serving.decode.kv_pages_used")
_occupancy = _obs.gauge("serving.decode.kv_occupancy")
_fragmentation = _obs.gauge("serving.decode.kv_fragmentation")

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
    nothing reads the scratch page)."""
    L, T, H, D = k_new.shape
    ps = k_pool.shape[2]
    n = T // ps
    idx = pages.long()
    k_pool.index_copy_(1, idx, k_new.reshape(L, n, ps, H, D).to(k_pool.dtype))
    v_pool.index_copy_(1, idx, v_new.reshape(L, n, ps, H, D).to(v_pool.dtype))


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
        _pages_total.set(self.num_pages - 1)
        self._publish(0)

    # -- allocator -----------------------------------------------------------
    @property
    def free_pages(self):
        """Pages an ``alloc`` could hand out right now."""
        return len(self._free)

    @property
    def used_pages(self):
        """Pages referenced by at least one live page table (rc >= 1)."""
        return self._used

    def pages_for(self, tokens):
        """Pages a ``tokens``-long sequence reserves (ceil)."""
        return -(-int(tokens) // self.page_size)

    def alloc(self, n):
        """Reserve ``n`` fresh rc=1 pages; returns their ids or None when
        the pool can't cover the reservation (the caller queues the
        sequence)."""
        n = int(n)
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self._used += n
        return pages

    def free(self, pages):
        """Drop one reference per page of a retired sequence's
        reservation; a page at rc=0 returns to the free list."""
        for p in pages:
            if p == 0:
                raise ServingError("page 0 is the scratch page; never owned")
            rc = self._rc[p]
            if rc < 1:
                raise ServingError("double free of page %d" % p)
            self._rc[p] = rc - 1
            if rc == 1:
                self._used -= 1
                self._free.append(p)

    def stats(self):
        """Allocator snapshot with the leaked-refcount sweep: every
        non-scratch page must be either rc >= 1 (used) or rc = 0 and on
        the free list.  ``rc_errors`` lists the pages that are neither or
        both; ``rc_sum_matches`` checks ``used_pages`` against the
        refcounts."""
        free = set(self._free)
        errors = []
        n_used = 0
        for p in range(1, self.num_pages):
            rc = self._rc[p]
            if rc < 0:
                errors.append((p, rc, "negative refcount"))
            elif rc > 0:
                n_used += 1
                if p in free:
                    errors.append((p, rc, "referenced page also in free "
                                   "list"))
            elif p not in free:
                errors.append((p, rc, "leaked: rc=0 but not in the free "
                               "list"))
        return {
            "num_pages": self.num_pages,
            "used_pages": self._used,
            "free_pages": self.free_pages,
            "rc_errors": errors,
            "rc_sum_matches": n_used == self._used,
        }

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
