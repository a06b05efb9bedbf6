"""Reader composition utilities (reference: python/paddle/reader/__init__.py).

The port's copy of ``paddle_tpu/reader``: the decorators, the creators
and ``batch``, and the device prefetch pipeline (``device_prefetch``:
host conversion, a pinned copy and a side-stream transfer on a
background thread), and ``master``, the fault-tolerant chunk-task
queue (``Master``, ``MasterClient``, ``master_task_reader``).
"""
from . import creator  # noqa: F401
from . import device_prefetch  # noqa: F401
from .creator import np_array, recordio, text_file  # noqa: F401
from .device_prefetch import (  # noqa: F401
    DevicePrefetcher,
    decorate_device_feed,
    device_feed_reader,
    put_feed_on_device,
)
from .decorator import (  # noqa: F401
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    multiprocess_reader,
    retry_reader,
    shuffle,
    xmap_readers,
)
from .master import Master, MasterClient, master_task_reader  # noqa: F401


def batch(reader, batch_size, drop_last=False):
    """Group samples into minibatches (reference: python/paddle/batch.py)."""

    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
