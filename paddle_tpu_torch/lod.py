"""Ragged-sequence representation (reference: LoDTensor,
paddle/fluid/framework/lod_tensor.h, and python/paddle/fluid/lod_tensor.py).

The port's copy of the JAX package's ``paddle_tpu/lod.py``.  The
reference's LoDTensor stores variable-length sequences concatenated
along dim 0 plus a level-of-detail offset table; here, as in the JAX
package, a batch of ragged sequences is a *dense padded* array
``[batch, max_len, ...]`` plus an int32 ``lengths[batch]`` vector, and
nested LoD (lod_level=2, e.g. paragraphs of sentences) adds a second
lengths array.  ``LoDArray`` is a host-side numpy container — the
DataFeeder produces it, and the Executor puts it on its own device as
two tensors (``name`` and ``name@LENGTHS``, plus ``name@SUBLENGTHS``
when nested); nothing here picks a device.

Nested (2-level) convention — rows are the INNERMOST sequences:
``data[row]`` is one padded innermost sequence, ``lengths[row]`` its token
count, and ``sub_lengths[g]`` counts how many rows belong to outer group
g (``sum(sub_lengths) == data.shape[0]``).  The reference's offset-LoD
``[[outer], [inner]]`` maps to ``recursive_sequence_lengths() ==
[sub_lengths, lengths]`` — level 0 is the outermost, as in the
reference.
"""
from __future__ import annotations

import numpy as np

__all__ = ["LoDArray", "LoDTensorArray", "create_lod_array", "create_lod_tensor",
           "create_random_int_lodtensor", "pack_sequences", "unpack_sequences"]


class LoDArray:
    """Host container: padded data + lengths (+ optional nested lengths)."""

    def __init__(self, data: np.ndarray, lengths: np.ndarray, sub_lengths: np.ndarray | None = None):
        self.data = np.asarray(data)
        self.lengths = np.asarray(lengths, dtype=np.int32)
        self.sub_lengths = None if sub_lengths is None else np.asarray(sub_lengths, dtype=np.int32)
        if self.data.shape[0] != self.lengths.shape[0]:
            raise ValueError("batch dims disagree: data %s vs lengths %s" % (self.data.shape, self.lengths.shape))

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def lod_level(self):
        return 1 if self.sub_lengths is None else 2

    def recursive_sequence_lengths(self):
        """Reference order: level 0 outermost.  Nested -> [outer group row
        counts, per-row token lengths]; flat -> [per-row token lengths]."""
        if self.sub_lengths is not None:
            return [self.sub_lengths.tolist(), self.lengths.tolist()]
        return [self.lengths.tolist()]

    # -- reference LoDTensor method surface (pybind lod_tensor) --------------
    def set(self, data, place=None):
        """Replace the payload (reference LoDTensor.set(ndarray, place))."""
        self.data = np.asarray(data)
        return self

    def set_recursive_sequence_lengths(self, recursive_seq_lens):
        levels = [np.asarray(l, np.int32) for l in recursive_seq_lens]
        if len(levels) > 2:
            raise ValueError(
                "LoDArray supports at most 2 LoD levels, got %d" % len(levels))
        if len(levels) == 2:
            # level 0 = outer group counts, level 1 = innermost (per-row)
            self.sub_lengths, self.lengths = levels[0], levels[1]
        else:
            self.lengths, self.sub_lengths = levels[0], None
        return self

    def has_valid_recursive_sequence_lengths(self):
        """Lengths consistent with the padded payload (the analog of the
        reference's offset-LoD validation)."""
        if self.lengths.shape[0] != self.data.shape[0]:
            return False
        if self.lengths.size and (self.lengths < 0).any():
            return False
        if self.sub_lengths is not None:
            if (self.sub_lengths < 0).any():
                return False
            if int(self.sub_lengths.sum()) != self.data.shape[0]:
                return False
        max_len = self.data.shape[1] if self.data.ndim > 1 else 0
        return not (self.lengths.size and int(self.lengths.max()) > max_len)

    def lod(self):
        """Offset-style LoD view (reference LoDTensor.lod): cumulative
        offsets per level, derived from the stored lengths."""
        out = []
        for lens in self.recursive_sequence_lengths():
            offs = [0]
            for n in lens:
                offs.append(offs[-1] + int(n))
            out.append(offs)
        return out

    def set_lod(self, lod):
        """Accept offset-style LoD (reference LoDTensor.set_lod)."""
        lens = [[b - a for a, b in zip(level, level[1:])] for level in lod]
        return self.set_recursive_sequence_lengths(lens)

    def __repr__(self):
        return "LoDArray(shape=%s, dtype=%s, lengths=%s)" % (self.data.shape, self.data.dtype, self.lengths.tolist())


def pack_sequences(seqs, pad_value=0, maxlen=None, dtype=None) -> LoDArray:
    """[array(len_i, ...)] -> LoDArray with padded [batch, max_len, ...]."""
    seqs = [np.asarray(s) for s in seqs]
    if dtype is None:
        dtype = seqs[0].dtype if seqs else np.float32
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    ml = int(maxlen if maxlen is not None else (lengths.max() if len(seqs) else 0))
    lengths = np.minimum(lengths, ml)
    trailing = seqs[0].shape[1:] if seqs else ()
    out = np.full((len(seqs), ml) + tuple(trailing), pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        L = min(len(s), ml)
        out[i, :L] = np.asarray(s[:L], dtype=dtype)
    return LoDArray(out, lengths)


def unpack_sequences(lod: LoDArray):
    """LoDArray -> list of unpadded arrays."""
    return [np.asarray(lod.data[i, : int(L)]) for i, L in enumerate(lod.lengths)]


def create_lod_array(data, recursive_seq_lens=None, place=None) -> LoDArray:
    """Reference-style constructor (fluid.create_lod_tensor,
    python/paddle/fluid/lod_tensor.py:24).  Accepts either a list of per-item
    arrays or a flat concatenated array + recursive_seq_lens."""
    if isinstance(data, LoDArray):
        return data
    if isinstance(data, (list, tuple)) and recursive_seq_lens is None:
        # list of per-sequence arrays, or list of GROUPS of per-sequence
        # arrays (nested): [[seq, seq], [seq]] -> 2-level.  A group's
        # elements must themselves be sequences (array-likes of rank >= 1);
        # a plain list of scalars like [1, 2, 3] is ONE 1-level sequence.
        def _is_group(g):
            return (isinstance(g, (list, tuple)) and len(g) > 0
                    and all(np.ndim(s) >= 1 for s in g))

        if data and all(_is_group(g) for g in data):
            counts = np.array([len(g) for g in data], np.int32)
            flat = [np.asarray(s) for g in data for s in g]
            out = pack_sequences(flat)
            out.sub_lengths = counts
            return out
        return pack_sequences(data)
    data = np.asarray(data)
    if recursive_seq_lens is None:
        return LoDArray(data, np.full((data.shape[0],), data.shape[1] if data.ndim > 1 else 1, np.int32))
    if len(recursive_seq_lens) == 1:
        lens = recursive_seq_lens[0]
        offs = np.concatenate([[0], np.cumsum(lens)])
        seqs = [data[offs[i]: offs[i + 1]] for i in range(len(lens))]
        return pack_sequences(seqs)
    if len(recursive_seq_lens) == 2:
        # reference flat layout (lod_tensor.py:24): data concatenates all
        # innermost tokens; level 0 counts inner sequences per outer item,
        # level 1 holds each inner sequence's token count
        outer, inner = recursive_seq_lens
        if int(np.sum(outer)) != len(inner):
            raise ValueError(
                "recursive_seq_lens inconsistent: outer counts sum to %d but "
                "%d inner lengths given" % (int(np.sum(outer)), len(inner)))
        if int(np.sum(inner)) != data.shape[0]:
            raise ValueError(
                "recursive_seq_lens inconsistent: inner lengths sum to %d but "
                "data has %d rows" % (int(np.sum(inner)), data.shape[0]))
        offs = np.concatenate([[0], np.cumsum(inner)])
        seqs = [data[offs[i]: offs[i + 1]] for i in range(len(inner))]
        out = pack_sequences(seqs)
        out.sub_lengths = np.asarray(outer, np.int32)
        return out
    raise ValueError("LoDArray supports at most 2 LoD levels, got %d" % len(recursive_seq_lens))


class LoDTensorArray(list):
    """Growable sequence of LoD tensors (reference: the pybind-bound
    ``vector<LoDTensor>``; here a plain list with the same ``append``
    surface, fed to / fetched from array ops)."""

    def append(self, tensor):
        list.append(self, tensor)
        return self


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Reference-spelling alias (python/paddle/fluid/lod_tensor.py:23):
    build the padded+lengths LoDArray from data + per-sequence lengths."""
    return create_lod_array(data, recursive_seq_lens, place)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None, low=0, high=10):
    """Random int LoD tensor (reference lod_tensor.py:74): one sequence per
    entry of the last-level lengths, values in [low, high]; outer levels are
    kept as the nested grouping."""
    lens = list(recursive_seq_lens[-1])
    seqs = [
        np.random.randint(low, high + 1, size=[L] + list(base_shape)).astype("int64")
        for L in lens
    ]
    out = pack_sequences(seqs)
    if len(recursive_seq_lens) == 2:
        outer = np.asarray(recursive_seq_lens[0], np.int32)
        if int(outer.sum()) != len(lens):
            raise ValueError(
                "outer counts sum to %d but %d inner sequences given"
                % (int(outer.sum()), len(lens)))
        out.sub_lengths = outer
    return out
