"""Request-scoped tracing: one trace tree per served request.

The PR-4 span layer answers "what is each THREAD doing" — spans land on
per-thread tracks keyed by wall time.  A serving operator's question is
transposed: "what happened to THIS request" — which crosses threads
(admission on a client thread, queue wait, the batcher worker, retries
and bisections inside the dispatcher) and interleaves with every other
request in the same batch.  A :class:`TraceContext` is the key that
reassembles that story: a ``trace_id`` minted at admission and carried
on the :class:`~paddle_tpu_torch.serving.request_queue.Request`, plus a span
id per emitted event so children (queue-wait, batch membership, each
execute attempt, each retry) point at their parent and the whole thing
is a tree.

Emission rides the EXISTING span plane — ``Telemetry.record_span`` with
``trace_id``/``span_id``/``parent_id`` tags — so trace events flow to
every attached span sink unchanged: :class:`~.sinks.ChromeTraceSink`
renders them as ``args`` (click a slice in Perfetto, read the trace id,
filter), and a ``JsonlSink(spans=True)`` writes them as ``type: "span"``
JSONL records for offline tree reconstruction
(:func:`build_trace_tree`).  When no span sink is attached the cost is
the usual one-tuple truthiness check — the request still CARRIES its
context (ids are cheap), only emission is gated.
"""
from __future__ import annotations

import itertools
import os
import threading

__all__ = ["TraceContext", "new_trace", "build_trace_tree"]

# Process-unique id space: a random prefix (so traces from co-hosted /
# restarted processes never collide in one collected file) + a counter
# (next() on itertools.count is atomic under the GIL — no lock on the
# admission path).
_PREFIX = os.urandom(4).hex()
_ids = itertools.count(1)


def _next_id():
    return "%s-%x" % (_PREFIX, next(_ids))


class TraceContext:
    """Identity of one node in a request's trace tree.

    ``trace_id`` names the tree (stable across every event of one
    request); ``span_id`` names this node; ``parent_id`` is the node it
    hangs under (None for the root).  Contexts are immutable — derive
    children with :meth:`child`.
    """

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id, span_id=None, parent_id=None):
        self.trace_id = trace_id
        self.span_id = span_id if span_id is not None else _next_id()
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        """A fresh child context: same trace, new span id, parented
        under this node."""
        return TraceContext(self.trace_id, parent_id=self.span_id)

    def tags(self, **extra):
        """The span-tag dict every trace event carries (sinks stringify
        values; keep them scalar)."""
        t = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            t["parent_id"] = self.parent_id
        if extra:
            t.update(extra)
        return t

    def __repr__(self):
        return ("TraceContext(trace=%s, span=%s, parent=%s)"
                % (self.trace_id, self.span_id, self.parent_id))


def new_trace() -> TraceContext:
    """Mint a root context (fresh trace id, no parent) — what admission
    stamps on every request that doesn't carry a caller-provided one."""
    return TraceContext(_next_id())


def build_trace_tree(spans, trace_id):
    """Reassemble one request's tree from collected span dicts.

    ``spans`` is an iterable of dicts with a ``tags`` mapping (the shape
    :class:`~.sinks.RingBufferSink` stores and ``JsonlSink(spans=True)``
    writes).  Returns ``(roots, by_span_id)`` where each node is
    ``{"span": <original>, "children": [...]}``; events whose parent was
    not captured surface as roots rather than being dropped."""
    nodes, order = {}, []
    for s in spans:
        tags = s.get("tags") or {}
        if tags.get("trace_id") != trace_id:
            continue
        sid = tags.get("span_id")
        node = {"span": s, "children": []}
        if sid is not None:
            nodes[sid] = node
        order.append((tags.get("parent_id"), node))
    roots = []
    for parent_id, node in order:
        parent = nodes.get(parent_id) if parent_id is not None else None
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots, nodes


# re-exported for sinks/tests that want a stable thread handle for
# cross-thread span attribution without importing threading themselves
current_thread = threading.current_thread
