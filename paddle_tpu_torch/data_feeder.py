"""DataFeeder (reference: python/paddle/fluid/data_feeder.py).

The port's copy of the JAX package's ``paddle_tpu/data_feeder.py``: it
converts python/minibatch data into the executor's feed dict.  Dense
slots become tensors on the feeder's place (``CUDAPlace`` by default,
as every entry point; pass the executor's place), ragged (lod) slots
become ``lod.LoDArray`` (padded + lengths, on the host), which the
Executor moves onto its device.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import np_dtype, resolve_device
from .framework import Variable
from .lod import create_lod_array, pack_sequences

__all__ = ["DataFeeder", "DataToLoDTensorConverter"]


class DataToLoDTensorConverter:
    """Collects one slot's samples; ``done()`` gives the slot's feed: a
    tensor on ``place`` (lod_level 0, reshaped to the slot's shape) or a
    host ``LoDArray``."""

    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = shape
        self.dtype = dtype
        self.data = []

    def feed(self, data):
        self.data.append(data)

    def done(self, host=False):
        """The slot's feed; ``host`` keeps a dense slot a numpy array."""
        if self.lod_level == 0:
            arr = np.asarray(self.data, dtype=np_dtype(self.dtype))
            if self.shape is not None:
                want = [d for d in self.shape if d != -1]
                if arr.ndim == 1 and len(want) > 0 and int(np.prod(want)) > 1:
                    arr = arr.reshape((-1,) + tuple(int(d) for d in self.shape if d != -1))
                elif arr.size == arr.shape[0] * int(np.prod(want or [1])):
                    try:
                        arr = arr.reshape((arr.shape[0],) + tuple(int(d) for d in (want or [])))
                    except ValueError:
                        pass
            if host:
                return arr
            return torch.as_tensor(arr).to(resolve_device(self.place))
        if self.lod_level >= 2:
            # nested samples: each sample is a list of innermost sequences
            groups = [
                [np.asarray(s, dtype=np_dtype(self.dtype)) for s in sample]
                for sample in self.data
            ]
            return create_lod_array(groups, None)
        seqs = [np.asarray(d, dtype=np_dtype(self.dtype)) for d in self.data]
        return pack_sequences(seqs, dtype=np_dtype(self.dtype))


class DataFeeder:
    """``DataFeeder(feed_list, place, program=None)``: ``feed(minibatch)``
    turns a list of samples (one entry per slot of ``feed_list``) into
    the feed dict, dense slots on ``place`` (None: the card, raising
    without one)."""

    def __init__(self, feed_list, place=None, program=None):
        from .framework import default_main_program

        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should be a list of Variable")
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape[1:] if each_var.shape else None)
        self.place = resolve_device(place)

    def feed(self, iterable):
        return self._convert(iterable, host=False)

    def _feed_host(self, iterable):
        """``feed``'s dict with its dense slots left as numpy arrays on
        the host (what the JAX package's feeder gives): the device
        prefetch pipeline casts, pins and transfers them itself."""
        return self._convert(iterable, host=True)

    def _convert(self, iterable, host):
        converters = [
            DataToLoDTensorConverter(self.place, lod, shape, dtype)
            for lod, shape, dtype in zip(self.feed_lod_level, self.feed_shapes, self.feed_dtypes)
        ]
        buffered = list(iterable) if not isinstance(iterable, (list, tuple)) else iterable
        for each_sample in buffered:
            if len(each_sample) != len(converters):
                raise ValueError("sample has %d slots, feeder expects %d"
                                 % (len(each_sample), len(converters)))
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        return {name: conv.done(host)
                for name, conv in zip(self.feed_names, converters)}

    def feed_parallel(self, iterable, num_places=None):
        """Yield one feed dict per place, the batch split evenly across
        them (reference data_feeder.py feed_parallel); num_places
        None/1 gives one full-batch dict."""
        n = num_places
        if n is not None and n < 1:
            raise ValueError("num_places must be >= 1, got %r" % n)
        if n is None or n == 1:
            yield self.feed(iterable)
            return
        yield from self._split_even(list(iterable), n)

    def _split_even(self, batch, n):
        """Feed dicts for an even n-way split (shared by feed_parallel and
        decorate_reader; raises if the batch doesn't divide)."""
        per, rem = divmod(len(batch), n)
        if rem or per == 0:
            raise ValueError(
                "batch of %d samples cannot be split across %d places"
                % (len(batch), n))
        for i in range(n):
            yield self.feed(batch[i * per:(i + 1) * per])

    def decorate_reader(self, reader, multi_devices, num_places=None, drop_last=True):
        """Wrap a sample reader into one yielding ready feed dicts
        (reference data_feeder.py decorate_reader).  With ``multi_devices``
        each yielded item is a list of ``num_places`` dicts (default: the
        CUDA device count), the batch split evenly; an uneven final batch
        is dropped (``drop_last``) or raises."""

        def split(batch, n):
            try:
                return list(self._split_even(batch, n))
            except ValueError:
                return None  # caller decides drop vs raise for this batch

        def decorated():
            if not multi_devices:
                for batch in reader():
                    yield self.feed(batch)
                return
            n = num_places if num_places is not None else torch.cuda.device_count()
            # one-batch lookahead: only the FINAL uneven batch may be
            # dropped; an uneven batch mid-stream is a config error
            pending = None
            for batch in reader():
                if pending is not None:
                    fed = split(pending, n)
                    if fed is None:
                        raise ValueError(
                            "batch of %d samples cannot be split across %d "
                            "devices" % (len(pending), n))
                    yield fed
                pending = batch
            if pending is not None:
                fed = split(pending, n)
                if fed is None and not drop_last:
                    raise ValueError(
                        "final batch of %d samples cannot be split across %d "
                        "devices (pass drop_last=True to drop it)"
                        % (len(pending), n))
                if fed is not None:
                    yield fed

        return decorated

    def to_device_reader(self, reader, executor, program=None,
                         buffer_size=2, transfer_threads=1):
        """Wrap a sample-batch reader into a creator yielding ON-DEVICE
        feed dicts: conversion and the host->device transfer (pinned
        memory, a side CUDA stream) both run on a background thread,
        double-buffered, so batch N+1 converts and transfers while the
        step for batch N computes (reader.device_prefetch).  The feeds
        land on the executor's device."""
        from .reader.device_prefetch import decorate_device_feed

        return decorate_device_feed(reader, self, executor, program=program,
                                    buffer_size=buffer_size,
                                    transfer_threads=transfer_threads)
