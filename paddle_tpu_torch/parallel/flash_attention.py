"""Attention kernels of the port: flash attention (forward, and two
backward engines) for training, paged attention for the decode runtime —
CUDA kernels and their plain PyTorch versions.

Counterpart of ``paddle_tpu/parallel/flash_attention.py``.  The JAX
package runs these functions as Pallas TPU kernels (``_fwd_kernel``,
``_fused_bwd_kernel``, ``_bwd_dkv_kernel`` + ``_bwd_dq_kernel``,
``_paged_decode_kernel``, ``_paged_prefill_kernel``); the port runs them
as hand-written CUDA kernels for Hopper
(``paddle_tpu_torch/csrc/flash_attention.cu`` and ``paged_attention.cu``,
built and loaded by :mod:`paddle_tpu_torch.cuda_kernels`).

Dispatch is by device.  A CPU tensor goes to the plain version
(``_flash_fwd_reference`` / ``_flash_bwd_reference`` /
``_flash_bwd_pair_reference`` / ``_paged_reference`` /
``_paged_prefill_reference``, translated from the JAX package's); a CUDA
tensor goes to the kernel, or the call raises.  The one choice left to
the caller is the flash backward's engine (:data:`FLASH_BWD_IMPL`: the
fused kernel or the two-pass pair); no value runs a plain version on a
CUDA tensor, and nothing falls back.  On the card the plain versions
serve only as the oracle that ``chip_smoke.py`` holds the kernels
against.

Layouts are the JAX package's: flash attention over ``[B, H, T, D]``
queries and ``[B, H, S, D]`` keys/values; paged queries ``[S, H, Dh]``
(decode) or ``[C, H, Dh]`` (a prefill chunk), one layer's pools
``[num_pages, page_size, H, Dh]``.  Contracts shared by every engine:
``kv_lens[b] == 0`` yields exact zeros (and, in the flash backward,
zero gradients); keys past a row's visibility are skipped; key/value
rows past ``kv_lens`` never reach a sum, so non-finite values there
change nothing.

The flash forward (B1) is also a PyTorch operator,
``torch.ops.paddle_tpu_torch.flash_fwd`` (a ``torch.library.custom_op``
registered when this module is imported): its CPU implementation is the
plain version ``_flash_fwd_reference``, its CUDA implementation the
kernel wrapper ``_flash_fwd_cuda``, and its fake implementation gives
the ``out`` and ``lse`` shapes.  Every forward goes through it, so
``torch.export`` traces B1 as one node of the graph (the serving AOT
backend, ``io.save_inference_model(..., aot=True)``) and a saved graph
launches the same kernel when it runs; the wrapper's checks, alignment
copies and its empty-input guard stay inside the implementation, out of
the traced graph.  Training keeps the autograd ``Function``
(``_FlashAttention``) around it.

Each kernel wrapper counts its launches in :data:`KERNEL_LAUNCHES`
(plain integers, incremented only where the kernel is launched, under a
lock: the predict batcher and the decode worker launch from their own
threads), so a run can show that its main path went through the
kernels; a graph loaded from an AOT artifact counts too, since the count
is in the operator's CUDA implementation.  A wrapper called while its
stream is being captured into a CUDA graph launches nothing: its count
goes to the capture's record (:func:`recording_launches`), and each
replay of the graph adds the record (:func:`add_launches`).
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
import warnings

import torch

__all__ = ["flash_attention", "mha_reference", "paged_decode_attention",
           "paged_prefill_attention", "KERNEL_LAUNCHES",
           "KERNEL_LAUNCHES_BY_DTYPE",
           "reset_launch_counts", "FLASH_BWD_IMPL"]

NEG_INF = -1e30

#: Launch counts of the CUDA kernels: the flash forward (B1), the fused
#: backward (B2), the two passes of the pair backward (B3), and the paged
#: kernels by public function name.
KERNEL_LAUNCHES = {"flash_attention_fwd": 0,
                   "flash_attention_bwd": 0,
                   "flash_attention_bwd_dkv": 0,
                   "flash_attention_bwd_dq": 0,
                   "paged_decode_attention": 0,
                   "paged_prefill_attention": 0}
#: The same launches split by the dtype of the tensors the kernel ran on:
#: ``{name: {"float32": n, "bfloat16": n}}`` (a run can show that its main
#: path ran a kernel on bfloat16 tensors).
KERNEL_LAUNCHES_BY_DTYPE = {name: {"float32": 0, "bfloat16": 0}
                            for name in KERNEL_LAUNCHES}
_LAUNCH_LOCK = threading.Lock()
# the records of the captures under way: capture stream handle ->
# {(kernel name, dtype name): launches}
_RECORDERS = {}


def _count_launch(*names, dtype):
    """Add one to each named kernel's launch count, and to its count for
    ``dtype``, the dtype of the tensors it ran on (the increments of two
    serving threads must not lose one another's).  On a stream being
    captured (the autograd thread runs a backward on its forward's
    stream) the launch goes to that capture's record instead."""
    key = str(dtype).replace("torch.", "")
    with _LAUNCH_LOCK:
        record = (_RECORDERS.get(torch.cuda.current_stream().cuda_stream)
                  if _RECORDERS else None)
        for name in names:
            if record is not None:
                record[(name, key)] = record.get((name, key), 0) + 1
            else:
                KERNEL_LAUNCHES[name] += 1
                KERNEL_LAUNCHES_BY_DTYPE[name][key] += 1


@contextlib.contextmanager
def recording_launches(stream):
    """Record, instead of count, the launches the wrappers make on
    ``stream`` while it is being captured into a CUDA graph; yields the
    record, ``{(kernel name, dtype name): launches}``, that each replay
    adds with :func:`add_launches`."""
    record = {}
    with _LAUNCH_LOCK:
        _RECORDERS[stream.cuda_stream] = record
    try:
        yield record
    finally:
        with _LAUNCH_LOCK:
            _RECORDERS.pop(stream.cuda_stream, None)


def add_launches(record):
    """Count the launches of one replay of a captured graph (the record
    :func:`recording_launches` made while it was captured)."""
    if not record:
        return
    with _LAUNCH_LOCK:
        for (name, key), n in record.items():
            KERNEL_LAUNCHES[name] += n
            KERNEL_LAUNCHES_BY_DTYPE[name][key] += n


# Backward engine switch, the counterpart of the JAX package's
# FLASH_BWD_IMPL: "fused" is B2 (a delta pre-pass, one walk over key tiles
# that sums dk, dv and each tile pair's dq partial, and a dq sum), "pair"
# is B3 (a delta pre-pass, a dk/dv pass over key tiles and a dq pass over
# query tiles), "auto" picks one on the card by _pick_bwd_engine.  On a
# CPU tensor "pair" runs the pair's plain version and "fused"/"auto" the
# plain backward _flash_bwd_reference.  Read once from
# PADDLE_TPU_TORCH_FLASH_BWD at import; set the attribute to change it in
# a running process.
_BWD_ENGINES = ("auto", "fused", "pair")
FLASH_BWD_IMPL = os.environ.get("PADDLE_TPU_TORCH_FLASH_BWD",
                                "auto").strip().lower()
if FLASH_BWD_IMPL not in _BWD_ENGINES:
    warnings.warn("PADDLE_TPU_TORCH_FLASH_BWD=%r is not one of "
                  "auto/fused/pair; using 'auto'" % FLASH_BWD_IMPL)
    FLASH_BWD_IMPL = "auto"


# Shared memory of one Hopper SM and what the runtime reserves for each
# resident block (CUDA C++ Programming Guide, compute capability 9.0).
_SM_SMEM_BYTES = 228 * 1024
_BLOCK_RESERVED_SMEM = 1024


def _b2_blocks_per_sm(D):
    """Blocks of B2's fused kernel (flash_bwd_fused_kernel<D>, B3's dk/dv
    blocks) one SM holds at once, as its shared memory limits them
    (csrc/flash_attention.cu:dkv_smem: four [64, D + 4] and two [64, 72]
    float tiles and two 64-float rows, 107,008 bytes at D 64): 3 at
    D = 32, 2 at D = 64, 1 at D = 128.  Registers are not counted: blocks
    of 128 threads fit two to an SM at up to 255 a thread, three at up to
    170.  chip_smoke.py's engine sweep states each shape's grid,
    B*H*ceil(S/64) blocks, as a share of B2's slots (this times the SM
    count)."""
    smem = (4 * 64 * (D + 4) + 2 * 64 * 72 + 2 * 64) * 4
    return _SM_SMEM_BYTES // (smem + _BLOCK_RESERVED_SMEM)


def _pick_bwd_engine(B, H, D, sm_count):
    """The backward engine ``auto`` runs on the card: a pure function of
    the shapes and the card's SM count (no timing at run time, so two
    runs pick the same engine and stay bitwise repeatable).

    Set from chip_smoke.py's engine sweep (PERF.md §6 has every row), on
    an NVIDIA H100 80GB HBM3 at 700 W with 132 SMs, float32, kv_lens as
    the training feeds draw them, comparing the engines' device times
    (each the sum of its three launches).  Since B2's redesign both
    engines run B3's dk/dv grid and register tiles, and B2 does 10*D
    operations a visible pair against B3's 14*D, at the price of a
    workspace of dq partials and its sum (about 7% of B2's time).  B2 is
    faster at all 32 rows, B2 / B3 not causal [causal]: bench.py's four
    Transformer shapes 0.72 [0.71] at [64, 8, 256, 64], 0.69 [0.72],
    0.70 [0.72] and 0.73 [0.73] at [4, 8, 4096, 64]; B2's grid from 3.9
    to 15.5 times its slots at D 64, 0.67-0.75; D 128 0.76-0.82; D 32
    0.64 [0.68].  So auto runs B2 everywhere; B3 stays the ``pair``
    engine, by name.  (After B3's redesign and before B2's, the pair won
    at every shape.)"""
    del B, H, D, sm_count  # the same engine at every measured shape
    return "fused"


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def reset_launch_counts():
    """Set every kernel's launch count to 0, per dtype too."""
    with _LAUNCH_LOCK:
        for name in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[name] = 0
            for key in KERNEL_LAUNCHES_BY_DTYPE[name]:
                KERNEL_LAUNCHES_BY_DTYPE[name][key] = 0


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
# Flash attention (training): plain versions, kernel wrappers and the
# autograd function.  The plain versions are translated from the JAX
# package's forward kernel (_fwd_kernel: out and lse from an online
# softmax) and its scan backward (_flash_bwd_scan: p recomputed from
# lse), computed densely here; f32 math (f64 for f64 inputs, so that
# torch.autograd.gradcheck can hold the backward against the forward).
# ---------------------------------------------------------------------------


def _flash_masks(B, T, S, kv_lens, causal, device):
    """(pair, key): [B, 1, T, S] visibility of (query, key) pairs and
    [B, 1, S, 1] validity of key rows (below kv_lens)."""
    cols = torch.arange(S, device=device)
    if kv_lens is None:
        key = torch.ones((B, S), dtype=torch.bool, device=device)
    else:
        key = cols[None, :] < kv_lens.to(device=device, dtype=torch.int64)[:, None]
    pair = key[:, None, None, :].expand(B, 1, T, S)
    if causal:
        rows = torch.arange(T, device=device)
        pair = pair & (cols[None, :] <= rows[:, None] + (S - T))[None, None]
    return pair, key[:, None, :, None]


def _flash_fwd_reference(q, k, v, kv_lens, causal, sm_scale):
    """(out, lse) of flash attention: out [B, H, T, D] in q's dtype, lse
    [B, H, T] float32 (float64 for float64 inputs).  A row with no
    visible key gets out = 0 and lse = -1e30 + log(1e-30), as the TPU
    kernel's max(l, 1e-30) division gives; key/value rows past kv_lens
    are zeroed before any product, as the TPU kernel zeroes them."""
    ct = torch.promote_types(q.dtype, torch.float32)
    B, H, T, _ = q.shape
    S = k.shape[2]
    pair, key = _flash_masks(B, T, S, kv_lens, causal, q.device)
    kf = torch.where(key, k.to(ct), 0.0)
    vf = torch.where(key, v.to(ct), 0.0)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kf) * sm_scale
    s = torch.where(pair, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(pair, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf) / denom
    lse = (m + torch.log(denom)).squeeze(-1)
    return out.to(q.dtype), lse


def _flash_bwd_reference(q, k, v, kv_lens, out, lse, do, causal, sm_scale):
    """(dq, dk, dv) of flash attention, as _flash_bwd_scan computes them:
    p = exp(s - lse) where the pair is visible (0 elsewhere, never
    0 * inf), delta = rowsum(do * out), ds = p (dp - delta) scale."""
    ct = torch.promote_types(q.dtype, torch.float32)
    B, H, T, _ = q.shape
    S = k.shape[2]
    pair, key = _flash_masks(B, T, S, kv_lens, causal, q.device)
    qf, dof = q.to(ct), do.to(ct)
    kf = torch.where(key, k.to(ct), 0.0)
    vf = torch.where(key, v.to(ct), 0.0)
    delta = (dof * out.to(ct)).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    p = torch.where(pair, torch.exp(s - lse.to(ct)[..., None]), 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = torch.where(pair, p * (dp - delta) * sm_scale, 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The pair's plain version, a tiled two-pass translation of the JAX
# package's _bwd_tiles + _bwd_dkv_kernel + _bwd_dq_kernel: dk/dv summed
# over query tiles for each key tile, dq summed over key tiles for each
# query tile, p and ds recomputed per tile pair with delta taken from the
# tile's own rows.  Every (b, h) is computed at once; a tile pair is
# skipped when no row of it can see a key (past every kv_lens, or above the
# causal diagonal), and within a computed pair the per-sequence kv_lens
# mask zeroes what a kernel block of that sequence would skip (its
# contribution is exactly 0: p and ds are 0 there and k, v are zeroed).


def _pair_setup(q, k, kv_lens):
    """(compute dtype, T, S, kv_lens as int64 [B, 1, 1, 1], the largest
    kv_lens)."""
    ct = torch.promote_types(q.dtype, torch.float32)
    B, T, S = q.shape[0], q.shape[2], k.shape[2]
    if kv_lens is None:
        lens = torch.full((B,), S, dtype=torch.int64, device=q.device)
    else:
        lens = kv_lens.to(device=q.device, dtype=torch.int64).clamp(0, S)
    top = int(lens.max()) if B else 0
    return ct, T, S, lens[:, None, None, None], top


def _pair_tile(ct, q, k, v, out, do, lse, lens, q0, k0, block_q, block_k,
               T, S, causal, sm_scale):
    """(p, ds, q, k, do) of one (query tile, key tile) pair for every
    (b, h), as _bwd_tiles computes them: rows past kv_lens zeroed in k and
    v, p = exp(s - lse) and ds = p (dp - delta) scale only where the pair
    is visible (0 elsewhere, never 0 * inf)."""
    rows = torch.arange(q0, min(q0 + block_q, T), device=q.device)
    cols = torch.arange(k0, min(k0 + block_k, S), device=q.device)
    qt = q[:, :, q0:q0 + block_q].to(ct)
    dot = do[:, :, q0:q0 + block_q].to(ct)
    colv = (cols[:, None] < lens)                     # [B, 1, bk, 1]
    kt = torch.where(colv, k[:, :, k0:k0 + block_k].to(ct), 0.0)
    vt = torch.where(colv, v[:, :, k0:k0 + block_k].to(ct), 0.0)
    ok = cols[None, :] < lens                         # [B, 1, 1, bk]
    if causal:
        ok = ok & (cols[None, :] <= rows[:, None] + (S - T))
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * sm_scale
    lse_t = lse[:, :, q0:q0 + block_q, None].to(ct)
    p = torch.where(ok, torch.exp(s - lse_t), 0.0)
    delta = (dot * out[:, :, q0:q0 + block_q].to(ct)).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dot, vt)
    ds = torch.where(ok, p * (dp - delta) * sm_scale, 0.0)
    return p, ds, qt, kt, dot


def _pair_dkv_reference(q, k, v, kv_lens, out, lse, do, causal, sm_scale,
                        block_q=64, block_k=64):
    """(dk, dv) of the pair's first pass (_bwd_dkv_kernel): for each key
    tile, the sum over the query tiles that can see it, in order."""
    ct, T, S, lens, top = _pair_setup(q, k, kv_lens)
    dk = torch.zeros(k.shape, dtype=ct, device=q.device)
    dv = torch.zeros(v.shape, dtype=ct, device=q.device)
    for k0 in range(0, min(S, top), block_k):
        first = max(0, k0 - (S - T)) // block_q * block_q if causal else 0
        for q0 in range(first, T, block_q):
            p, ds, qt, _, dot = _pair_tile(ct, q, k, v, out, do, lse, lens,
                                           q0, k0, block_q, block_k, T, S,
                                           causal, sm_scale)
            dv[:, :, k0:k0 + block_k] += torch.einsum("bhqk,bhqd->bhkd",
                                                      p, dot)
            dk[:, :, k0:k0 + block_k] += torch.einsum("bhqk,bhqd->bhkd",
                                                      ds, qt)
    return dk.to(k.dtype), dv.to(v.dtype)


def _pair_dq_reference(q, k, v, kv_lens, out, lse, do, causal, sm_scale,
                       block_q=64, block_k=64):
    """dq of the pair's second pass (_bwd_dq_kernel): for each query tile,
    the sum over the key tiles its rows can see, in order."""
    ct, T, S, lens, top = _pair_setup(q, k, kv_lens)
    dq = torch.zeros(q.shape, dtype=ct, device=q.device)
    for q0 in range(0, T, block_q):
        kend = min(S, top)
        if causal:
            kend = min(kend, min(q0 + block_q, T) + (S - T))
        for k0 in range(0, kend, block_k):
            _, ds, _, kt, _ = _pair_tile(ct, q, k, v, out, do, lse, lens,
                                         q0, k0, block_q, block_k, T, S,
                                         causal, sm_scale)
            dq[:, :, q0:q0 + block_q] += torch.einsum("bhqk,bhkd->bhqd",
                                                      ds, kt)
    return dq.to(q.dtype)


def _flash_bwd_pair_reference(q, k, v, kv_lens, out, lse, do, causal,
                              sm_scale, block_q=64, block_k=64):
    """(dq, dk, dv) of flash attention by the two-pass pair (B3's plain
    version; the CUDA kernels use 64-row tiles)."""
    args = (q, k, v, kv_lens, out, lse, do, causal, sm_scale, block_q,
            block_k)
    dk, dv = _pair_dkv_reference(*args)
    return _pair_dq_reference(*args), dk, dv


def _strides(t):
    """(batch, head, time) strides of a [B, H, T, D] tensor whose last
    dimension is contiguous; any other tensor is copied to a contiguous
    one first (the Program's transposed views need no copy)."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        t = t.contiguous()
    return t, list(t.stride()[:3])


def _aligned16(t):
    """(t, its (batch, head, time) strides) for a kernel that stages rows
    with 16-byte copies (cp.async, or 16-byte loads of bfloat16): the
    base pointer and every stride but the last (contiguous) one must be
    multiples of 16 bytes.  The Program's transposed views and fresh
    tensors are; any other tensor is copied to a fresh contiguous one
    first (a layout copy, computing the same function)."""
    t, st = _strides(t)
    size = t.element_size()
    if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:-1]):
        t = t.clone(memory_format=torch.contiguous_format)
        st = list(t.stride()[:3])
    return t, st


def _check_flash_inputs(q, k, v, kv_lens, name):
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError("%s: the CUDA kernel takes q, k, v all float32 or all "
                        "bfloat16, got %s, %s, %s"
                        % (name, q.dtype, k.dtype, v.dtype))
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
            q.shape[:2] != k.shape[:2]) or q.shape[3] != k.shape[3]:
        raise ValueError("%s: q [B, H, T, D] and k, v [B, H, S, D] do not "
                         "match: %s, %s, %s" % (name, tuple(q.shape),
                                                tuple(k.shape), tuple(v.shape)))
    if q.shape[3] not in (32, 64, 128):
        raise ValueError("%s: the CUDA kernel takes head_dim 32, 64 or 128, "
                         "got %d" % (name, q.shape[3]))
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("%s: all tensors must be on %s, got one on %s"
                             % (name, q.device, t.device))
    if kv_lens is not None and (
            kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (q.shape[0],)
            or kv_lens.device != q.device or not kv_lens.is_contiguous()):
        raise ValueError("%s: kv_lens must be a contiguous int32 [B] tensor "
                         "on %s" % (name, q.device))


def _device_index(t):
    return t.device.index if t.device.index is not None else \
        torch.cuda.current_device()


def _flash_fwd_cuda(q, k, v, kv_lens, causal, sm_scale):
    from ..cuda_kernels import load_library

    name = "flash_attention_fwd"
    _check_flash_inputs(q, k, v, kv_lens, name)
    B, H, T, D = q.shape
    S = k.shape[2]
    out = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if B * H * T == 0:
        return out, lse
    # the kernel stages q, k and v rows with 16-byte copies
    q, qs = _aligned16(q)
    k, ks = _aligned16(k)
    v, vs = _aligned16(v)
    err = load_library().pt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_lens is None else kv_lens.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, T, S, D, *qs, *ks, *vs,
        int(causal), float(sm_scale), int(q.dtype == torch.bfloat16),
        _device_index(q), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    _count_launch(name, dtype=q.dtype)
    return out, lse


def _check_bwd_inputs(q, k, v, kv_lens, out, lse, do, name):
    """Check what the backward kernels take; returns ``do`` in q's
    dtype."""
    _check_flash_inputs(q, k, v, kv_lens, name)
    B, H, T, D = q.shape
    if do.dtype != q.dtype:
        do = do.to(q.dtype)
    if (tuple(out.shape) != (B, H, T, D) or tuple(do.shape) != (B, H, T, D)
            or out.dtype != q.dtype or tuple(lse.shape) != (B, H, T)
            or lse.dtype != torch.float32 or not lse.is_contiguous()
            or any(t.device != q.device for t in (out, do, lse))):
        raise ValueError("%s: out/do must be [B, H, T, D] in q's dtype and "
                         "lse a contiguous float32 [B, H, T], all on %s"
                         % (name, q.device))
    return do


def _b2_workspace_shape(B, H, T, S, D):
    """Shape of B2's float32 workspace of dq partials: one [T, D] slice
    for each (b*h, 64-key tile), of which the fused kernel writes the rows
    of the query tiles that walk that key tile."""
    return (B * H, -(-S // 64), T, D)


def _flash_bwd_cuda(q, k, v, kv_lens, out, lse, do, causal, sm_scale):
    """(dq, dk, dv) from B2: a delta pre-pass, the fused kernel (dk, dv
    and dq partials into a workspace), then the dq sum."""
    from ..cuda_kernels import load_library

    name = "flash_attention_bwd"
    do = _check_bwd_inputs(q, k, v, kv_lens, out, lse, do, name)
    B, H, T, D = q.shape
    S = k.shape[2]
    dq = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, H, S, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, H, S, D), dtype=v.dtype, device=q.device)
    if B * H * T * S == 0:  # no visible pair: every gradient is zero
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    ws = torch.empty(_b2_workspace_shape(B, H, T, S, D), dtype=torch.float32,
                     device=q.device)
    # the fused kernel stages q, k, v and do rows with 16-byte copies
    q, qs = _aligned16(q)
    k, ks = _aligned16(k)
    v, vs = _aligned16(v)
    do, dos = _aligned16(do)
    out, os_ = _strides(out)
    err = load_library().pt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), None if kv_lens is None else kv_lens.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws.data_ptr(), delta.data_ptr(), B, H, T, S, D, *qs, *ks, *vs,
        *os_, *dos, int(causal), float(sm_scale),
        int(q.dtype == torch.bfloat16), _device_index(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    _count_launch(name, dtype=q.dtype)
    return dq, dk, dv


def _flash_bwd_pair_cuda(q, k, v, kv_lens, out, lse, do, causal, sm_scale):
    """(dq, dk, dv) from B3: a delta pre-pass, then its two kernels, the
    dk/dv kernel first."""
    from ..cuda_kernels import load_library

    name = "flash_attention_bwd_pair"
    do = _check_bwd_inputs(q, k, v, kv_lens, out, lse, do, name)
    B, H, T, D = q.shape
    S = k.shape[2]
    dq = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, H, S, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, H, S, D), dtype=v.dtype, device=q.device)
    if B * H * T * S == 0:  # no visible pair: every gradient is zero
        return dq.zero_(), dk.zero_(), dv.zero_()
    # delta = rowsum(do * out), written by the kernels' pre-pass
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    q, qs = _aligned16(q)
    k, ks = _aligned16(k)
    v, vs = _aligned16(v)
    do, dos = _aligned16(do)
    out, os_ = _strides(out)
    err = load_library().pt_flash_bwd_pair(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), None if kv_lens is None else kv_lens.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, T, S, D, *qs, *ks, *vs, *os_, *dos,
        int(causal), float(sm_scale),
        int(q.dtype == torch.bfloat16), _device_index(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    _count_launch("flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                  dtype=q.dtype)
    return dq, dk, dv


# B1 as a PyTorch operator: one schema, the plain version on the CPU, the
# kernel on the card, and shapes alone under tracing (torch.export)
_flash_fwd_op = torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor? kv_lens, bool causal, "
           "float sm_scale) -> (Tensor, Tensor)")(_flash_fwd_reference)
_flash_fwd_op.register_kernel("cuda")(_flash_fwd_cuda)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, kv_lens, causal, sm_scale):
    """(out [B, H, T, D] in q's dtype, lse [B, H, T] float32, float64 for
    float64 inputs), as both implementations give them."""
    B, H, T, D = q.shape
    lse_dtype = torch.promote_types(q.dtype, torch.float32)
    return q.new_empty((B, H, T, D)), q.new_empty((B, H, T), dtype=lse_dtype)


def _flash_fwd(q, k, v, kv_lens, causal, sm_scale):
    _dispatch(q, "flash_attention")
    return torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, kv_lens, causal,
                                                sm_scale)


def _flash_bwd(q, k, v, kv_lens, out, lse, do, causal, sm_scale):
    engine = FLASH_BWD_IMPL
    if engine not in _BWD_ENGINES:
        raise ValueError("FLASH_BWD_IMPL must be auto, fused or pair, got %r"
                         % (engine,))
    args = (q, k, v, kv_lens, out, lse, do, causal, sm_scale)
    if _dispatch(q, "flash_attention") == "plain":
        if engine == "pair":
            return _flash_bwd_pair_reference(*args)
        return _flash_bwd_reference(*args)
    if engine == "auto":
        B, H, _, D = q.shape
        engine = _pick_bwd_engine(B, H, D, _sm_count(_device_index(q)))
    if engine == "pair":
        return _flash_bwd_pair_cuda(*args)
    return _flash_bwd_cuda(*args)


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``jax.custom_vjp`` pair: the forward saves
    (q, k, v, kv_lens, out, lse), as ``_flash_vjp_fwd`` does; kv_lens
    gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, sm_scale):
        out, lse = _flash_fwd(q, k, v, kv_lens, causal, sm_scale)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, kv_lens, out, lse, do, ctx.causal,
                                ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_lens=None, causal=False, sm_scale=None):
    """Fused attention, [B, H, T, D] queries against [B, H, S, D] keys and
    values → [B, H, T, D], differentiable in q, k and v.

    ``kv_lens`` ([B] int32) masks keys at or past each sequence's length
    (a row of a sequence with ``kv_lens == 0`` yields zeros); ``causal``
    masks bottom-right aligned (row t sees keys <= t + S - T) and needs
    T <= S.  CPU tensors run the plain versions; CUDA tensors the
    hand-written kernels (float32 or bfloat16, head_dim 32/64/128; q, k,
    v may be strided views whose last dimension is contiguous), which
    pick their own tiles and raise on inputs they do not take.  The
    backward runs the engine :data:`FLASH_BWD_IMPL` names."""
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(
            "causal flash_attention requires T <= S, got T=%d S=%d"
            % (q.shape[2], k.shape[2]))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, kv_lens, bool(causal),
                                 float(sm_scale))


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


# B4's split: whole pages, at most this many keys
# (csrc/paged_attention.cu:kSplitKeys; the C entry refuses a workspace
# with another split count)
_B4_SPLIT_KEYS = 256


def _b4_split_pages(ps):
    """Pages a B4 split covers at page size ``ps``: a constant of the page
    size alone (256 keys at ps 16), never of S, kv_lens or the card, so a
    slot's bits do not depend on the batch it decodes in."""
    return max(1, _B4_SPLIT_KEYS // ps)


def _b4_workspace_shape(S, H, mp, ps, Dh):
    """Shape of B4's float32 workspace: one (acc[Dh], m, l) record for
    each (slot, head, split), written once by the split kernel and read in
    split order by the merge kernel."""
    return (S, H, -(-mp // _b4_split_pages(ps)), Dh + 2)


def _paged_decode_cuda(q, k_pool, v_pool, page_tables, kv_lens, sm_scale):
    """B4: the split kernel (one block per (split, head, slot)) and the
    merge kernel, launched by one C call.  Never reads kv_lens on the host:
    the workspace and the grid come from the shapes alone."""
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
    out = torch.empty((S, H, Dh), dtype=q.dtype, device=q.device)
    if S == 0:
        return out
    ps, mp = k_pool.shape[1], page_tables.shape[1]
    ws = torch.empty(_b4_workspace_shape(S, H, mp, ps, Dh),
                     dtype=torch.float32, device=q.device)
    # the split kernel reads q 16 bytes at a time and stages the pools'
    # rows with 16-byte copies
    q, k_pool, v_pool = (_aligned16(t)[0] for t in (q, k_pool, v_pool))
    err = load_library().pt_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), ws.shape[2], S, H, Dh, ps, mp, float(sm_scale),
        int(k_pool.dtype == torch.bfloat16), _device_index(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    _count_launch(name, dtype=k_pool.dtype)
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
    # the kernel stages q and the pools' rows with 16-byte copies
    q, k_pool, v_pool = (_aligned16(t)[0] for t in (q, k_pool, v_pool))
    err = load_library().pt_paged_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pages.data_ptr(), out.data_ptr(), C, H, Dh, k_pool.shape[1],
        pages.shape[0], int(start), float(sm_scale),
        int(k_pool.dtype == torch.bfloat16), _device_index(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    _count_launch(name, dtype=k_pool.dtype)
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
        whose output row is exactly zero.  A slot sees at most the
        ``max_pages * page_size`` keys its page-table row can hold.

    CPU tensors run the plain version, CUDA tensors the kernel (same
    input requirements as :func:`paged_prefill_attention`), whose result
    for a slot depends on that slot's q, kv_lens and pages alone: it is
    the same bits in any batch.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _dispatch(q, "paged_decode_attention") == "plain":
        return _paged_reference(q, k_pool, v_pool, page_tables, kv_lens,
                                sm_scale)
    return _paged_decode_cuda(q, k_pool, v_pool, page_tables, kv_lens,
                              sm_scale)
