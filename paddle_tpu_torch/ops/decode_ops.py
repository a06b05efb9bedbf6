"""Beam-search decode op rules: ``beam_search`` and ``beam_search_decode``.

Translated from the JAX package's ``paddle_tpu/ops/decode_ops.py``, whose
layout they keep: the beam is a static axis (every tensor ``[batch,
beam]``, plus a trailing candidate axis), a finished beam is a lane that
keeps emitting ``end_id`` with a frozen score, and a beam's parent is an
explicit ``parent_idx [batch, beam]`` output.  Both are a handful of
small torch ops a decode step; no Pallas kernel ever computed them.
"""
from __future__ import annotations

import torch

from ..registry import register


@register("beam_search")
def _beam_search(ctx, op):
    """One step: the ``beam_size`` best of the ``beam * K`` candidates of
    each source.  A finished lane (``pre_ids == end_id``) offers one
    candidate, ``end_id`` at its frozen score, and -1e9 in its other
    slots.  Equal scores keep ``lax.top_k``'s order, the lower flat index
    first (a stable descending sort): step 0's lanes past the first and
    finished lanes tie exactly at -1e9."""
    pre_ids = ctx.get_input(op, "pre_ids")        # [B, beam] int
    pre_scores = ctx.get_input(op, "pre_scores")  # [B, beam]
    ids = ctx.get_input(op, "ids")                # [B, beam, K] int
    scores = ctx.get_input(op, "scores")          # [B, beam, K] accumulated
    beam_size = int(op.attrs["beam_size"])
    end_id = int(op.attrs["end_id"])

    B, beam, K = ids.shape
    finished = (pre_ids == end_id)[..., None]     # [B, beam, 1]
    slot0 = torch.arange(K, device=ids.device) == 0
    # Python scalars, not tensors made on the device: each of those is a
    # copy from the host, which waits for the device
    cand_scores = torch.where(
        finished, torch.where(slot0, pre_scores[..., None], -1e9), scores)
    cand_ids = torch.where(finished, end_id, ids)
    sorted_scores, order = torch.sort(cand_scores.reshape(B, beam * K),
                                      dim=1, descending=True, stable=True)
    flat_idx = order[:, :beam_size]
    ctx.set_output(op, "selected_ids",
                   torch.gather(cand_ids.reshape(B, beam * K), 1, flat_idx))
    ctx.set_output(op, "selected_scores", sorted_scores[:, :beam_size])
    ctx.set_output(op, "parent_idx", (flat_idx // K).to(torch.int32))


@register("beam_search_decode", reads_host=True)
def _beam_search_decode(ctx, op):
    """Backtrace the step arrays ``Ids``, ``Parents`` and ``Scores`` (each
    ``[capacity, B, beam]``, ``@ARRAYLEN`` steps of them written) into one
    row a hypothesis: ``SentenceIds [B * beam, capacity]``, ``end_id``
    past the written steps, with ``@LENGTHS`` (tokens up to and including
    the first ``end_id``, at most the written steps) and ``@SUBLENGTHS``
    (``beam`` rows a source); ``SentenceScores [B * beam]``, the last
    written step's scores.  The walk reads the step count on the host
    (one sync) and visits the written steps from the last back; a step
    past them passes every lane through, as in the JAX package.  Parents
    lie in [0, beam), as ``beam_search`` writes them."""
    ids_name = op.inputs["Ids"][0]
    ids_buf = ctx.get(ids_name + "@ARRAY")                     # [T, B, beam]
    parents_buf = ctx.get(op.inputs["Parents"][0] + "@ARRAY")
    scores_buf = ctx.get(op.inputs["Scores"][0] + "@ARRAY")
    n_dev = ctx.get(ids_name + "@ARRAYLEN")                    # int32 []
    end_id = int(op.attrs["end_id"])
    T, B, beam = ids_buf.shape
    n = int(n_dev)
    dev = ids_buf.device

    path = torch.arange(beam, device=dev).expand(B, beam)
    cols = [None] * T
    for t in range(min(n, T) - 1, -1, -1):
        cols[t] = torch.gather(ids_buf[t], 1, path)
        path = torch.gather(parents_buf[t], 1, path).long()
    pad = torch.full((B, beam), end_id, dtype=ids_buf.dtype, device=dev)
    sentence_ids = torch.stack([pad if c is None else c for c in cols], -1)
    flat = sentence_ids.reshape(B * beam, T)

    is_end = flat == end_id
    first_end = is_end.to(torch.int8).argmax(1)  # first True, 0 if none
    hyp_len = torch.where(is_end.any(1), first_end + 1, n).clamp(max=n)
    scores = scores_buf[min(max(n - 1, 0), T - 1)]            # [B, beam]
    out_name = op.outputs["SentenceIds"][0]
    ctx.set_output(op, "SentenceIds", flat)
    ctx.set_lengths(out_name, hyp_len.to(torch.int32))
    per_source = torch.full((B,), beam, dtype=torch.int32, device=dev)
    ctx.set_sub_lengths(out_name, per_source)
    sc_name = op.outputs["SentenceScores"][0]
    ctx.set_output(op, "SentenceScores", scores.reshape(B * beam))
    ctx.set_lengths(sc_name, torch.ones((B * beam,), dtype=torch.int32,
                                        device=dev))
    ctx.set_sub_lengths(sc_name, per_source)
