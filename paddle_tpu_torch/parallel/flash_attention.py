"""Paged attention for the decode runtime: CUDA kernels and their plain
PyTorch versions.

Counterpart of ``paddle_tpu/parallel/flash_attention.py``.  The JAX
package runs these two functions as Pallas TPU kernels
(``_paged_decode_kernel``, ``_paged_prefill_kernel``); the port runs
them as hand-written CUDA kernels for Hopper
(``paddle_tpu_torch/csrc/paged_attention.cu``, built and loaded by
:mod:`paddle_tpu_torch.cuda_kernels`).

Dispatch is by device only.  A CPU tensor goes to the plain version
(``_paged_reference`` / ``_paged_prefill_reference``, translated from
the JAX package's references); a CUDA tensor goes to the kernel, or the
call raises.  There is no override and no fallback: on the card, the
plain versions serve only as the oracle that ``chip_smoke.py`` holds the
kernels against.

Layouts are the JAX package's: queries ``[S, H, Dh]`` (decode) or
``[C, H, Dh]`` (a prefill chunk), one layer's pools
``[num_pages, page_size, H, Dh]``.  Contracts shared by every engine:
``kv_lens[s] == 0`` yields exact zeros; pages past a row's visibility
are skipped; stale page tails never reach the sum.

Each kernel wrapper counts its launches in :data:`KERNEL_LAUNCHES`
(plain integers, incremented only where the kernel is launched), so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import math

import torch

__all__ = ["mha_reference", "paged_decode_attention",
           "paged_prefill_attention", "KERNEL_LAUNCHES",
           "reset_launch_counts"]

NEG_INF = -1e30

#: Launch counts of the CUDA kernels, by public function name.
KERNEL_LAUNCHES = {"paged_decode_attention": 0,
                   "paged_prefill_attention": 0}


def reset_launch_counts():
    """Set every kernel's launch count to 0."""
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def mha_reference(q, k, v, causal=False, sm_scale=None, kv_lens=None):
    """Plain attention over ``[B, H, T, D]`` tensors (f32 math).

    ``causal`` is bottom-right aligned (``tril(k=S-T)``); ``kv_lens``
    ([B] int) masks keys at or past each sequence's length, and a row
    whose ``kv_lens`` entry is 0 yields zeros."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    T, S = s.shape[-2], s.shape[-1]
    if causal:
        mask = torch.ones((T, S), dtype=torch.bool, device=s.device).tril(S - T)
        s = torch.where(mask, s, NEG_INF)
    if kv_lens is not None:
        mask = (torch.arange(S, device=s.device)[None, :]
                < kv_lens.to(s.device)[:, None])  # [B, S]
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if kv_lens is not None:
        p = torch.where(kv_lens.to(s.device)[:, None, None, None] > 0, p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Plain versions (translated from the JAX package's _paged_reference and
# _paged_prefill_reference): gather the pages out of the pool and run the
# masked softmax over the full page-table span.
# ---------------------------------------------------------------------------


def _paged_reference(q, k_pool, v_pool, page_tables, kv_lens, sm_scale):
    S, H, Dh = q.shape
    ps = k_pool.shape[1]
    mp = page_tables.shape[1]
    idx = page_tables.long()
    k = k_pool[idx].reshape(S, mp * ps, H, Dh).float()
    v = v_pool[idx].reshape(S, mp * ps, H, Dh).float()
    s = torch.einsum("shd,skhd->shk", q.float(), k) * sm_scale
    lens = kv_lens.to(q.device)
    ok = torch.arange(mp * ps, device=q.device)[None, :] < lens[:, None]
    s = torch.where(ok[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(lens[:, None, None] > 0, p, 0.0)  # inactive slot -> 0
    return torch.einsum("shk,skhd->shd", p, v).to(q.dtype)


def _paged_prefill_reference(q, k_pool, v_pool, pages, start, sm_scale):
    C, H, Dh = q.shape
    ps = k_pool.shape[1]
    mp = pages.shape[0]
    idx = pages.long()
    k = k_pool[idx].reshape(mp * ps, H, Dh).float()
    v = v_pool[idx].reshape(mp * ps, H, Dh).float()
    s = torch.einsum("chd,khd->chk", q.float(), k) * sm_scale
    # causal over cache order: row i (absolute position start + i) sees
    # keys [0, start + i], itself included
    lens = int(start) + torch.arange(C, device=q.device) + 1
    ok = torch.arange(mp * ps, device=q.device)[None, :] < lens[:, None]
    s = torch.where(ok[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("chk,khd->chd", p, v).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers: check what the kernel takes, allocate the output, launch
# on the current stream, raise on a launch error, count the launch.
# ---------------------------------------------------------------------------


def _check_kernel_inputs(q, k_pool, v_pool, tables, name):
    if q.dtype != torch.float32:
        raise TypeError("%s: the CUDA kernel takes float32 queries, got %s"
                        % (name, q.dtype))
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError("%s: pools must both be float32 or bfloat16, got "
                        "%s and %s" % (name, k_pool.dtype, v_pool.dtype))
    if k_pool.shape != v_pool.shape:
        raise ValueError("%s: k_pool %s and v_pool %s differ in shape"
                         % (name, tuple(k_pool.shape), tuple(v_pool.shape)))
    Dh, H = q.shape[-1], q.shape[-2]
    if Dh not in (32, 64, 128):
        raise ValueError("%s: the CUDA kernel takes head_dim 32, 64 or 128, "
                         "got %d" % (name, Dh))
    if k_pool.shape[2:] != (H, Dh):
        raise ValueError("%s: pool heads/head_dim %s do not match q %s"
                         % (name, tuple(k_pool.shape[2:]), (H, Dh)))
    if not 1 <= k_pool.shape[1] <= 32:
        raise ValueError("%s: the CUDA kernel takes page_size 1..32, got %d"
                         % (name, k_pool.shape[1]))
    if tables.dtype != torch.int32:
        raise TypeError("%s: page tables must be int32, got %s"
                        % (name, tables.dtype))
    for t in (q, k_pool, v_pool, tables):
        if t.device != q.device:
            raise ValueError("%s: all tensors must be on %s, got one on %s"
                             % (name, q.device, t.device))
        if not t.is_contiguous():
            raise ValueError("%s: the CUDA kernel takes contiguous tensors"
                             % name)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError("%s: CUDA kernel launch failed with error %d (%s)"
                           % (name, err, torch.cuda.get_device_name()))


def _paged_decode_cuda(q, k_pool, v_pool, page_tables, kv_lens, sm_scale):
    from ..cuda_kernels import load_library

    name = "paged_decode_attention"
    _check_kernel_inputs(q, k_pool, v_pool, page_tables, name)
    S, H, Dh = q.shape
    if page_tables.dim() != 2 or page_tables.shape[0] != S:
        raise ValueError("%s: page_tables must be [S=%d, max_pages], got %s"
                         % (name, S, tuple(page_tables.shape)))
    if (kv_lens.dtype != torch.int32 or kv_lens.shape != (S,)
            or kv_lens.device != q.device or not kv_lens.is_contiguous()):
        raise ValueError("%s: kv_lens must be a contiguous int32 [S] tensor "
                         "on %s" % (name, q.device))
    out = torch.empty_like(q)
    if S == 0:
        return out
    lib = load_library()
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    err = lib.pt_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        S, H, Dh, k_pool.shape[1], page_tables.shape[1], float(sm_scale),
        int(k_pool.dtype == torch.bfloat16), dev,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    KERNEL_LAUNCHES[name] += 1
    return out


def _paged_prefill_cuda(q, k_pool, v_pool, pages, start, sm_scale):
    from ..cuda_kernels import load_library

    name = "paged_prefill_attention"
    _check_kernel_inputs(q, k_pool, v_pool, pages, name)
    C, H, Dh = q.shape
    if pages.dim() != 1:
        raise ValueError("%s: pages must be [max_pages], got %s"
                         % (name, tuple(pages.shape)))
    out = torch.empty_like(q)
    if C == 0:
        return out
    lib = load_library()
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    err = lib.pt_paged_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pages.data_ptr(), out.data_ptr(), C, H, Dh, k_pool.shape[1],
        pages.shape[0], int(start), float(sm_scale),
        int(k_pool.dtype == torch.bfloat16), dev,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    KERNEL_LAUNCHES[name] += 1
    return out


def _dispatch(q, name):
    if q.device.type == "cpu":
        return "plain"
    if q.device.type == "cuda":
        return "cuda"
    raise ValueError("%s: tensors on %s are not supported (cpu or cuda)"
                     % (name, q.device))


def paged_prefill_attention(q, k_pool, v_pool, pages, start, sm_scale=None):
    """Chunk-of-prompt attention against one sequence's paged KV.

    q: [C, H, Dh] — one prefill chunk's query tokens, absolute positions
        ``start .. start + C - 1`` (pad tail rows allowed; their outputs
        are garbage the caller ignores).
    k_pool / v_pool: [num_pages, page_size, H, Dh] — ONE layer's pool;
        the chunk's own k/v must already be written in.
    pages: [max_pages] int32 — the sequence's full page-table row in
        order; unused entries must point at a valid (scratch) page.
    start: int — absolute position of the chunk's first row.  Row i
        attends keys ``[0, start + i]`` (causal over cache order).

    Every row's result depends on its absolute position alone, not on C
    or ``start``: chunked and monolithic prefill give the same bits on
    each engine.  CPU tensors run the plain version, CUDA tensors the
    kernel (which needs float32 queries, float32 or bfloat16 pools,
    head_dim 32/64/128 and page_size <= 32, and raises otherwise).
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _dispatch(q, "paged_prefill_attention") == "plain":
        return _paged_prefill_reference(q, k_pool, v_pool, pages, start,
                                        sm_scale)
    return _paged_prefill_cuda(q, k_pool, v_pool, pages, start, sm_scale)


def paged_decode_attention(q, k_pool, v_pool, page_tables, kv_lens,
                           sm_scale=None):
    """Single-token-query attention against a paged KV pool.

    q: [S, H, Dh] — one query token per decode slot.
    k_pool / v_pool: [num_pages, page_size, H, Dh] — ONE layer's pool.
    page_tables: [S, max_pages] int32 — slot s's kv lives in pages
        ``page_tables[s, :ceil(kv_lens[s]/page_size)]`` in order; unused
        entries must point at a valid (scratch) page id.
    kv_lens: [S] int32 — tokens of valid kv per slot; 0 = inactive slot,
        whose output row is exactly zero.

    CPU tensors run the plain version, CUDA tensors the kernel (same
    input requirements as :func:`paged_prefill_attention`).
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _dispatch(q, "paged_decode_attention") == "plain":
        return _paged_reference(q, k_pool, v_pool, page_tables, kv_lens,
                                sm_scale)
    return _paged_decode_cuda(q, k_pool, v_pool, page_tables, kv_lens,
                              sm_scale)
