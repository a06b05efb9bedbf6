"""Op-frequency statistics (reference:
python/paddle/fluid/contrib/op_frequence.py) — counts op types in a Program
(and adjacent-op pairs), useful for spotting fusion candidates.  A copy
of the JAX package's ``contrib/op_frequence.py``."""
from __future__ import annotations

from collections import OrderedDict

__all__ = ["op_freq_statistic"]


def op_freq_statistic(program):
    """Returns (single_op_count, pair_op_count) OrderedDicts, most frequent
    first."""
    uni = {}
    pair = {}
    for blk in program.blocks:
        prev = None
        for op in blk.ops:
            uni[op.type] = uni.get(op.type, 0) + 1
            if prev is not None:
                key = "%s->%s" % (prev, op.type)
                pair[key] = pair.get(key, 0) + 1
            prev = op.type
    s = OrderedDict(sorted(uni.items(), key=lambda kv: -kv[1]))
    p = OrderedDict(sorted(pair.items(), key=lambda kv: -kv[1]))
    return s, p
