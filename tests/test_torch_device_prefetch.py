"""The port's device-feed pipeline (``paddle_tpu_torch.reader.
device_prefetch``) on the CPU: the non-mesh cases of
``tests/unittests/test_device_prefetch.py``.

- prefetch-on training is BITWISE-equal to prefetch-off (the pipeline
  moves work off the critical path, it never changes values), and the
  losses equal the JAX package's prefetched run's within LOSS_RTOL from
  the same parameters;
- feeds already on the executor's device dispatch with ZERO host feed
  copies (``executor.feed_host_copy_count``) and each batch transfers
  exactly once (``device_prefetch.transfer_count``);
- abandoning the pipeline (close, break, a dropped prefetcher) leaves no
  live producer thread and closes the source reader;
- reader and conversion errors reach the consumer;
- a slow reader's cost overlaps compute (timing, generous margins);
- host values are cast to the declared dtype before the transfer.

On the card the transfer is a pinned copy on the pipeline's own CUDA
stream, handed to the consumer's stream by an event; chip_smoke.py's
Trainer phase checks that (a CUDA tensor needs the card).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.reader import device_prefetch as jdevice_prefetch
from paddle_tpu_torch import executor as executor_mod
from paddle_tpu_torch.reader import device_prefetch

WIDTH = 8
BATCH = 8
LOSS_RTOL = 1e-5


def build_model(fl=fluid):
    main = fl.Program()
    startup = fl.Program()
    with fl.unique_name.guard():
        with fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[WIDTH], dtype="float32")
            y = fl.layers.data(name="y", shape=[1], dtype="float32")
            h = fl.layers.fc(x, size=WIDTH, act="relu")
            pred = fl.layers.fc(h, size=1)
            loss = fl.layers.mean(fl.layers.square(pred - y))
            fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def sample_batches(n_batches, seed=0, delay=0.0):
    rng = np.random.RandomState(seed)
    batches = [
        [(rng.randn(WIDTH).astype(np.float32),
          rng.randn(1).astype(np.float32)) for _ in range(BATCH)]
        for _ in range(n_batches)
    ]

    def reader():
        for b in batches:
            if delay:
                time.sleep(delay)
            yield b

    return reader


def _train(async_feed, steps=6, state=None):
    """(persistables after ``steps`` SGD steps, losses), from ``state``
    where given, else a seeded startup."""
    np.random.seed(5)
    main, startup, loss = build_model()
    main.random_seed = 1234
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    feeder = fluid.DataFeeder(feed_list=["x", "y"], place=fluid.CPUPlace(),
                              program=main)
    reader = sample_batches(steps)
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        if state is not None:
            fluid.load_numpy_state(main, state, device="cpu")
        if async_feed:
            feeds = device_prefetch.decorate_device_feed(
                reader, feeder, exe, main, buffer_size=2)()
        else:
            feeds = (feeder.feed(b) for b in reader())
        try:
            for feed in feeds:
                out = exe.run(main, feed=feed, fetch_list=[loss])
                losses.append(float(np.ravel(np.asarray(out[0]))[0]))
        finally:
            close = getattr(feeds, "close", None)
            if close is not None:
                close()
        assert np.isfinite(losses[-1])
        params = {
            n: scope[n].clone()
            for n in sorted(main.persistable_names()) if n in scope
        }
    return params, losses


def test_async_training_bitwise_equals_sync():
    sync, _ = _train(False)
    async_, _ = _train(True)
    assert sync.keys() == async_.keys()
    for n in sync:
        assert sync[n].numpy().tobytes() == async_[n].numpy().tobytes(), (
            "prefetch changed parameter %r" % n)
    _assert_no_pipeline_threads()


def test_prefetched_training_matches_jax():
    """The same six steps through each package's pipeline, from the JAX
    startup's parameters."""
    np.random.seed(5)
    main, startup, loss = build_model(jfluid)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    feeder = jfluid.DataFeeder(feed_list=["x", "y"], place=jfluid.CPUPlace(),
                               program=main)
    want = []
    with jfluid.scope_guard(scope):
        exe.run(startup)
        state = {n: np.asarray(scope[n]) for n in main.persistable_names()
                 if n in scope}
        for feed in jdevice_prefetch.decorate_device_feed(
                sample_batches(6), feeder, exe, main)():
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            want.append(float(np.ravel(np.asarray(lv))[0]))
    _, got = _train(True, state=state)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def test_on_device_feeds_zero_host_copies():
    """Executor.run with feeds already on its device performs no host feed
    copies, and the fast path stays engaged."""
    np.random.seed(5)
    main, startup, loss = build_model()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    feeder = fluid.DataFeeder(feed_list=["x", "y"], place=fluid.CPUPlace(),
                              program=main)
    batch = next(iter(sample_batches(1)()))
    with fluid.scope_guard(scope):
        exe.run(startup)
        dev_feed = device_prefetch.put_feed_on_device(
            feeder._feed_host(batch), exe, main)
        for v in dev_feed.values():  # really on the executor's device
            assert isinstance(v, torch.Tensor) and v.device == exe.device
        for _ in range(3):  # engage + bind the fast path
            exe.run(main, feed=dev_feed, fetch_list=[loss])
        assert exe._bound, "fast path never bound with device feeds"
        before = executor_mod.feed_host_copy_count()
        t_before = device_prefetch.transfer_count()
        for _ in range(5):
            out = exe.run(main, feed=dev_feed, fetch_list=[loss])
        np.asarray(out[0])
        assert executor_mod.feed_host_copy_count() == before, (
            "on-device feeds paid host-side conversions")
        assert device_prefetch.transfer_count() == t_before, (
            "steady-state dispatch re-transferred feeds already placed")
        # control: host feeds DO count host conversions (the instrument
        # itself works), bound or op by op
        exe.run(main, feed=feeder._feed_host(batch), fetch_list=[loss])
        exe.run(main, feed=feeder._feed_host(batch), fetch_list=[loss],
                use_program_cache=False)
        assert executor_mod.feed_host_copy_count() > before


def test_prefetcher_transfers_each_batch_once():
    np.random.seed(5)
    main, startup, loss = build_model()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    feeder = fluid.DataFeeder(feed_list=["x", "y"], place=fluid.CPUPlace(),
                              program=main)
    with fluid.scope_guard(scope):
        exe.run(startup)
        before = device_prefetch.transfer_count()
        feeds = feeder.to_device_reader(sample_batches(4), exe, main)()
        for feed in feeds:
            exe.run(main, feed=feed, fetch_list=[loss])
    # 4 batches x 2 feed vars, one transfer each
    assert device_prefetch.transfer_count() - before == 8


def _pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("paddle-tpu-device-prefetch",
                                  "paddle-tpu-buffered-pump",
                                  "paddle-tpu-interleave-pump"))]


def _assert_no_pipeline_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _pipeline_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _pipeline_threads(), (
        "producer threads leaked: %r" % _pipeline_threads())


def _setup():
    np.random.seed(5)
    main, startup, loss = build_model()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    feeder = fluid.DataFeeder(feed_list=["x", "y"], place=fluid.CPUPlace(),
                              program=main)
    return main, startup, loss, scope, exe, feeder


def test_prefetcher_abandoned_early_leaves_no_threads_and_closes_reader():
    main, startup, loss, scope, exe, feeder = _setup()
    closed = []
    batches = sample_batches(1000, delay=0.001)

    def reader():
        try:
            yield from batches()
        finally:
            closed.append(True)

    with fluid.scope_guard(scope):
        exe.run(startup)
        feeds = device_prefetch.decorate_device_feed(
            reader, feeder, exe, main, buffer_size=2)()
        first = next(feeds)
        exe.run(main, feed=first, fetch_list=[loss])
        feeds.close()  # consumer walks away mid-stream
    _assert_no_pipeline_threads()
    assert closed, "underlying reader was not closed on abandonment"


def test_prefetcher_break_out_of_for_loop_leaves_no_threads():
    main, startup, loss, scope, exe, feeder = _setup()
    with fluid.scope_guard(scope):
        exe.run(startup)
        feeds = device_prefetch.decorate_device_feed(
            sample_batches(500, delay=0.001), feeder, exe, main)()
        try:
            for i, feed in enumerate(feeds):
                exe.run(main, feed=feed, fetch_list=[loss])
                if i == 1:
                    break
        finally:
            feeds.close()
    _assert_no_pipeline_threads()


def test_prefetcher_dropped_without_close_is_finalized():
    """A raw DevicePrefetcher abandoned WITHOUT close() must still tear
    down via its GC finalizer — the worker threads deliberately hold no
    reference to the instance, so dropping the last ref reclaims it."""
    import gc

    def endless():
        while True:
            yield {"x": np.zeros((2, WIDTH), np.float32)}

    pf = device_prefetch.DevicePrefetcher(endless(), buffer_size=2)
    next(pf)
    del pf
    gc.collect()
    _assert_no_pipeline_threads()


def test_prefetcher_propagates_reader_error():
    main, startup, _loss, scope, exe, feeder = _setup()
    good = sample_batches(2)

    def broken():
        yield from good()
        raise IOError("corrupt shard mid-stream")

    with fluid.scope_guard(scope):
        exe.run(startup)
        feeds = device_prefetch.decorate_device_feed(
            broken, feeder, exe, main)()
        got = []
        with pytest.raises(IOError, match="corrupt shard"):
            for feed in feeds:
                got.append(feed)
    assert len(got) == 2, "samples before the failure must be delivered"
    _assert_no_pipeline_threads()


def test_prefetcher_propagates_conversion_error():
    main, startup, _loss, scope, exe, feeder = _setup()

    def bad_batches():
        yield [(np.zeros(WIDTH, np.float32),)] * BATCH  # missing a slot

    feeds = device_prefetch.decorate_device_feed(
        bad_batches, feeder, exe, main)()
    with pytest.raises(ValueError, match="slots"):
        list(feeds)
    _assert_no_pipeline_threads()


def test_slow_reader_overlaps_compute():
    """A reader sleeping 20ms/batch against a step loop costing ~15ms
    (exe.run on a tiny model + a sleep standing in for device compute).
    Serially that is ~35ms/step; with the prefetcher the reader's cost
    must hide behind the steps."""
    main, startup, loss, scope, exe, feeder = _setup()
    n, delay, work = 10, 0.02, 0.015
    with fluid.scope_guard(scope):
        exe.run(startup)
        warm = feeder.feed(next(iter(sample_batches(1)())))
        for _ in range(3):
            np.asarray(exe.run(main, feed=warm, fetch_list=[loss])[0])

        def leg(async_feed):
            reader = sample_batches(n, delay=delay)
            t0 = time.perf_counter()
            if async_feed:
                feeds = device_prefetch.decorate_device_feed(
                    reader, feeder, exe, main, buffer_size=2)()
            else:
                feeds = (feeder.feed(b) for b in reader())
            try:
                for feed in feeds:
                    np.asarray(exe.run(main, feed=feed,
                                       fetch_list=[loss])[0])
                    time.sleep(work)
            finally:
                close = getattr(feeds, "close", None)
                if close is not None:
                    close()
            return time.perf_counter() - t0

        t_sync = leg(False)
        t_async = leg(True)
    # sync pays reader + step serially (~0.35s); async hides the reader
    # behind the steps (~0.22s)
    assert t_async < 0.8 * t_sync, (
        "no overlap: sync %.3fs async %.3fs (reader floor %.3fs)"
        % (t_sync, t_async, n * delay))


def test_trainer_routes_reader_through_prefetch_bitwise():
    def run(prefetch):
        np.random.seed(17)

        def train_func():
            x = fluid.layers.data(name="x", shape=[WIDTH], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            h = fluid.layers.fc(x, size=WIDTH, act="relu")
            pred = fluid.layers.fc(h, size=1)
            return fluid.layers.mean(fluid.layers.square(pred - y))

        trainer = fluid.Trainer(
            train_func=train_func,
            optimizer_func=lambda: fluid.optimizer.SGD(learning_rate=0.1),
            place=fluid.CPUPlace())
        trainer.train_program.random_seed = 77
        before = device_prefetch.transfer_count()
        trainer.train(num_epochs=1, reader=sample_batches(5),
                      feed_order=["x", "y"], prefetch=prefetch)
        moved = device_prefetch.transfer_count() - before
        return {
            n: trainer.scope[n].numpy().copy()
            for n in sorted(trainer.train_program.persistable_names())
            if n in trainer.scope
        }, moved

    off, moved_off = run(False)
    on, moved_on = run(True)
    assert (moved_off, moved_on) == (0, 10)
    assert off.keys() == on.keys()
    for n in off:
        assert off[n].tobytes() == on[n].tobytes(), (
            "Trainer prefetch changed parameter %r" % n)
    _assert_no_pipeline_threads()


def test_prefetcher_casts_to_declared_dtype_off_critical_path():
    main, startup, _loss = build_model()
    exe = fluid.Executor(fluid.CPUPlace())
    feed = {"x": np.zeros((BATCH, WIDTH), np.float64),
            "y": np.zeros((BATCH, 1), np.float64)}
    dev = device_prefetch.put_feed_on_device(feed, exe, main)
    assert dev["x"].dtype == torch.float32
    assert dev["y"].dtype == torch.float32


def test_mesh_feed_lists_raise_naming_a11():
    with pytest.raises(NotImplementedError, match="A11"):
        device_prefetch.shard_feed_list([{}], None, [])
