"""Parameter-server shard dispatchers (reference:
python/paddle/fluid/transpiler/ps_dispatcher.py).

The port's copy of the JAX package's ``transpiler/ps_dispatcher.py``,
with one change (R-14): ``HashName`` places a variable by the CRC-32 of
its UTF-8 name, which every process computes alike.  The JAX package
uses Python's ``hash()``, which is salted per process
(``PYTHONHASHSEED``), so a trainer and a pserver started as separate
processes can disagree on which endpoint owns a gradient.
"""
from __future__ import annotations

import zlib

__all__ = ["PSDispatcher", "RoundRobin", "HashName"]


class PSDispatcher:
    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError


class HashName(PSDispatcher):
    """Shard by crc32(var name) % #pservers: the same map in every
    process."""

    def _hash_block(self, block_str, total):
        return zlib.crc32(str(block_str).encode("utf-8")) % total

    def dispatch(self, varlist):
        return [self._eps[self._hash_block(v.name, len(self._eps))]
                for v in varlist]


class RoundRobin(PSDispatcher):
    """Cycle endpoints in order."""

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self._eps[self._step % len(self._eps)])
            self._step += 1
        return out
