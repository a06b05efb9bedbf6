"""The port's predict serving (``serving.InferenceEngine(model_dir=...)``)
on the CPU: the cases of the JAX package's ``tests/unittests/
test_serving.py`` against the port's engine, plus an engine that serves
a saved model and a decode model together.

The model is the JAX package's test MLP (fc 16 relu, fc 4 softmax over
8 features), saved by the port with ``aot=True``.  Bitwise contracts are
port-vs-port: coalesced serving equals sequential serving from bucket 2
on, the AOT graph equals the Program, and a swapped-in version answers
exactly as an engine that loaded it first.  Probabilities sum to 1
within 1e-5 (float32).
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.testing import faults

BUCKETS = (2, 4)


def _save_model(dirname, seed=17, aot=False, two_fetches=False):
    main = fluid.Program()
    startup = fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        out = fluid.layers.fc(h, size=4, act="softmax")
        fetches = [out, h] if two_fetches else [out]
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ["x"], fetches, exe,
                                      main_program=main, aot=aot)
    return dirname


def _engine(model_dir, **kw):
    kw.setdefault("batch_buckets", BUCKETS)
    return serving.InferenceEngine(model_dir, device="cpu", **kw)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serving") / "model")
    return _save_model(d, aot=True)


def test_predict_and_futures(model_dir):
    with _engine(model_dir, backend="program") as eng:
        assert eng.health()["device"] == "cpu"
        X = np.random.RandomState(0).randn(2, 8).astype("float32")
        (out,) = eng.predict({"x": X})
        assert out.shape == (2, 4)
        np.testing.assert_allclose(np.sum(out, axis=1), 1.0, rtol=1e-5)
        fut = eng.predict_async({"x": X})
        (out2,) = fut.result(timeout=30)
        assert fut.done()
        assert out2.tobytes() == out.tobytes()  # deterministic replay
        # a sample without the batch dim is auto-batched to rows=1
        (row,) = eng.predict({"x": X[0]})
        assert row.shape == (1, 4)
        assert row.tobytes() == np.ascontiguousarray(out[:1]).tobytes()
        assert eng.feed_names == ["x"] and len(eng.fetch_names) == 1


def test_multi_fetch_slicing(tmp_path):
    d = _save_model(str(tmp_path / "m2"), seed=19, two_fetches=True)
    with _engine(d) as eng:
        X = np.random.RandomState(1).randn(3, 8).astype("float32")
        out, hidden = eng.predict({"x": X})
        assert out.shape == (3, 4) and hidden.shape == (3, 16)


def test_malformed_requests_raise(model_dir):
    with _engine(model_dir, backend="program") as eng:
        X = np.zeros((1, 8), "float32")
        with pytest.raises(serving.ServingError, match="feed names"):
            eng.predict({"y": X})
        with pytest.raises(serving.ServingError, match="max_batch_size"):
            eng.predict({"x": np.zeros((9, 8), "float32")})
        with pytest.raises(serving.ServingError, match="expects"):
            eng.predict({"x": np.zeros((1, 5), "float32")})
        with pytest.raises(serving.ServingError, match="dims"):
            eng.predict({"x": np.zeros((1, 1, 1, 8), "float32")})
        with pytest.raises(serving.ServingError, match="priority"):
            eng.predict({"x": X}, priority="urgent")
        # a good request still works after the bad ones
        assert eng.predict({"x": X})[0].shape == (1, 4)


def test_bucket_padding_counters(model_dir):
    with _engine(model_dir, backend="program") as eng:
        pad0 = obs.counter("serving.padded_rows").value
        b4_0 = obs.counter("serving.batch_bucket_4").value
        X = np.random.RandomState(2).randn(3, 8).astype("float32")
        (out,) = eng.predict({"x": X})  # 3 rows -> bucket 4, 1 padded row
        assert out.shape == (3, 4)
        assert obs.counter("serving.padded_rows").value == pad0 + 1
        assert obs.counter("serving.batch_bucket_4").value == b4_0 + 1


@pytest.mark.parametrize("backend", ["program", "aot"])
def test_batched_equals_sequential(model_dir, backend):
    """Concurrent coalesced serving is bitwise-identical to sequential
    (never-coalesced) serving of the same requests."""
    rng = np.random.RandomState(3)
    payloads = [rng.randn(rng.randint(1, 3), 8).astype("float32")
                for _ in range(12)]
    with _engine(model_dir, backend=backend) as eng:
        want = [eng.predict({"x": p})[0] for p in payloads]  # sequential
        results = [None] * len(payloads)

        def client(lo, hi):
            for i in range(lo, hi):
                results[i] = eng.predict({"x": payloads[i]}, timeout=30)[0]

        threads = [threading.Thread(target=client, args=(t * 3, t * 3 + 3))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    for i in range(len(payloads)):
        assert results[i].tobytes() == want[i].tobytes(), i


def test_aot_backend_matches_program_backend(model_dir):
    X = np.random.RandomState(4).randn(2, 8).astype("float32")
    with _engine(model_dir, backend="program") as prog_eng:
        assert prog_eng.health()["backend"] == "program"
        want = prog_eng.predict({"x": X})[0]
    with _engine(model_dir, backend="aot") as aot_eng:
        assert aot_eng.health()["backend"] == "aot"
        got = aot_eng.predict({"x": X})[0]
    with _engine(model_dir) as auto_eng:     # auto prefers the artifact
        assert auto_eng.health()["backend"] == "aot"
    assert got.tobytes() == want.tobytes()


def test_model_load_retries_flaky_reads(tmp_path):
    """Inference artifact reads ride the resilience choke point — a
    transiently flaky model mount retries and the load wins."""
    d = _save_model(str(tmp_path / "m"), seed=23, aot=True)
    retries0 = obs.counter("resilience.retry").value
    with faults.flaky_io("__model__", times=2, op="read") as fired:
        with _engine(d, batch_buckets=(2,), backend="program") as eng:
            assert eng.ready()
    assert fired[0] == 2
    assert obs.counter("resilience.retry").value >= retries0 + 2

    with faults.flaky_io("__aot_torch__", times=1, op="read") as fired:
        predict, _, _ = fluid.io.load_aot_inference_model(d, device="cpu")
        X = np.zeros((2, 8), "float32")
        assert predict({"x": X})[0].shape == (2, 4)
    assert fired[0] == 1


def test_model_load_fails_cleanly_past_retry_budget(tmp_path):
    """A persistently unreadable artifact exhausts the retry budget and
    surfaces the injected error instead of hanging or half-loading."""
    d = _save_model(str(tmp_path / "m"), seed=29)
    with faults.flaky_io("__model__", times=50, op="read"):
        with pytest.raises(faults.FaultInjected):
            serving.ModelStore(place="cpu").load(d, backend="program")


def test_hot_swap_idle_engine(tmp_path):
    d1 = _save_model(str(tmp_path / "v1"), seed=31)
    d2 = _save_model(str(tmp_path / "v2"), seed=32)
    X = np.random.RandomState(5).randn(2, 8).astype("float32")
    with _engine(d1) as eng:
        v1 = eng.model_version
        out1 = eng.predict({"x": X})[0]
        swaps0 = obs.counter("serving.swaps").value
        v2 = eng.swap_model(d2)
        assert v2 > v1 and eng.model_version == v2 and eng.ready()
        assert obs.counter("serving.swaps").value == swaps0 + 1
        out2 = eng.predict({"x": X})[0]
        assert out1.tobytes() != out2.tobytes()
        with _engine(d2) as ref:
            assert out2.tobytes() == ref.predict({"x": X})[0].tobytes()


def test_swap_to_an_incompatible_model_is_refused(tmp_path):
    d1 = _save_model(str(tmp_path / "v1"), seed=33)
    d3 = str(tmp_path / "other")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        y = fluid.layers.data(name="other", shape=[4], dtype="float32")
        out = fluid.layers.fc(y, size=2)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(d3, ["other"], [out], exe,
                                      main_program=main)
    X = np.ones((1, 8), "float32")
    with _engine(d1) as eng:
        before = eng.predict({"x": X})[0]
        version = eng.model_version
        with pytest.raises(serving.ServingError, match="swap rejected"):
            eng.swap_model(d3)
        assert eng.ready() and eng.model_version == version
        assert eng.predict({"x": X})[0].tobytes() == before.tobytes()


def test_stop_drains_and_rejects(model_dir):
    eng = _engine(model_dir, backend="program", autostart=False)
    X = np.zeros((1, 8), "float32")
    futs = [eng.predict_async({"x": X}) for _ in range(3)]
    eng.start()
    eng.stop(drain=True)
    for f in futs:  # queued work was answered before shutdown
        assert f.result(timeout=5)[0].shape == (1, 4)
    with pytest.raises(serving.ServingClosed):
        eng.predict({"x": X})
    assert eng.state == "stopped" and not eng.ready()
    # idempotent
    eng.stop()


def test_no_leaked_serving_threads(model_dir):
    before = {t.ident for t in threading.enumerate()}
    eng = _engine(model_dir, batch_buckets=(2,), backend="program")
    eng.predict({"x": np.zeros((1, 8), "float32")})
    eng.stop()
    deadline = time.time() + 5
    while time.time() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.ident not in before and "serving" in t.name]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, "serving threads leaked: %s" % alive


def test_warmup_runs_every_bucket_twice(model_dir):
    """After construction every bucket has run (twice, as the JAX
    package's warm-up does), and the batch-dim verdict of each fetch is
    known; a swap warms the new version the same way."""
    timer = obs.timer("serving.warmup")
    n0 = timer.count
    with _engine(model_dir, backend="program") as eng:
        assert sorted(eng._model.warmed_buckets) == sorted(BUCKETS)
        assert eng._model.batched_fetch == [True]
        assert timer.count == n0 + len(BUCKETS)
        rng = np.random.RandomState(6)
        for rows in (1, 2, 3, 4, 2, 1):
            (out,) = eng.predict({"x": rng.randn(rows, 8).astype("float32")})
            assert out.shape == (rows, 4)
    with _engine(model_dir, backend="program", warmup=False) as cold:
        assert cold._model.warmed_buckets == []
        assert cold._model.batched_fetch is None


def test_nonbatched_fetch_with_bucket_sized_lead_dim(tmp_path):
    """A fetch that does NOT carry the batch dim but whose leading dim
    equals a bucket size must come back whole, not sliced per request —
    warmup establishes per-fetch batch-dim ground truth."""
    main = fluid.Program()
    startup = fluid.Program()
    startup.random_seed = 53
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        out = fluid.layers.fc(x, size=4, act="softmax",
                              param_attr=fluid.ParamAttr(name="w_fetch"))
    w_var = main.global_block().var("w_fetch")  # (8, 4): lead == bucket 8
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    d = str(tmp_path / "m")
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [out, w_var], exe,
                                      main_program=main)
        w_full = scope["w_fetch"].numpy().copy()
    with _engine(d, batch_buckets=(2, 8), backend="program") as eng:
        assert eng._model.batched_fetch == [True, False]
        X = np.random.RandomState(8).randn(5, 8).astype("float32")
        probs, w_got = eng.predict({"x": X})  # 5 rows -> bucket 8
        assert probs.shape == (5, 4)
        assert w_got.shape == (8, 4), "non-batched fetch was sliced"
        assert w_got.tobytes() == w_full.tobytes()


def test_oversized_batch_chunked_across_buckets(model_dir):
    """A coalesced batch with more rows than the largest bucket is
    chunked across several bucket dispatches with per-request slice
    order preserved, bitwise-equal to sequential serving."""
    rng = np.random.RandomState(5)
    eng = _engine(model_dir, max_batch_size=16, backend="program",
                  autostart=False)
    ref = _engine(model_dir, backend="program")
    try:
        b0 = obs.counter("serving.batches").value
        # queue BEFORE starting the batcher so one coalesced batch carries
        # 3+4+2=9 rows > max(batch_buckets)=4
        payloads = [rng.randn(n, 8).astype("float32") for n in (3, 4, 2)]
        futs = [eng.predict_async({"x": p}) for p in payloads]
        eng.start()
        got = [f.result(timeout=60)[0] for f in futs]
        n_dispatch = obs.counter("serving.batches").value - b0
        assert n_dispatch >= 3, n_dispatch
        for p, g in zip(payloads, got):
            want = np.concatenate(
                [ref.predict({"x": p[i:i + 1]})[0]
                 for i in range(p.shape[0])])
            assert g.shape == p.shape[:1] + (4,)
            assert g.tobytes() == want.tobytes()
        # a single oversized request (rows > largest bucket) also chunks
        big = rng.randn(11, 8).astype("float32")
        (out,) = eng.predict({"x": big})
        want = np.concatenate([ref.predict({"x": big[i:i + 1]})[0]
                               for i in range(11)])
        assert out.tobytes() == want.tobytes()
    finally:
        eng.stop()
        ref.stop()


def test_entry_points_default_to_the_card(model_dir):
    """``place=None``/``device=None`` mean the card; with no GPU here the
    engine, the store and the AOT loader raise before touching a file."""
    for call in (lambda: serving.InferenceEngine(model_dir),
                 lambda: serving.ModelStore(),
                 lambda: fluid.io.load_aot_inference_model(model_dir)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="place or device"):
        serving.InferenceEngine(model_dir, place="cpu", device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        with _engine(model_dir) as eng:
            eng.serve_metrics()


def test_one_engine_serves_predict_and_generate(model_dir):
    """``model_dir`` and ``decode_model`` in one engine: both paths
    answer, each as an engine of its own does; admission to each path
    gates on its own worker."""
    params, meta = TT.lm_params(seed=7, vocab_size=50, n_layer=2, n_head=2,
                                d_model=32, d_inner=64, max_length=64)
    cfg = serving.DecodeConfig(num_slots=2, page_size=8, max_seq_len=64,
                               max_new_tokens=6)
    prompts = [np.random.RandomState(s).randint(1, 50, size=n)
               .astype(np.int32) for s, n in ((1, 5), (2, 11))]
    X = np.random.RandomState(9).randn(3, 8).astype("float32")
    model = TT.build_decode_model(params, meta, device="cpu")
    with _engine(model_dir, decode_model=model, decode_config=cfg) as both:
        assert set(both.health()["workers"]) == {"batcher", "decoder"}
        gen = [both.generate_async(p) for p in prompts]
        (probs,) = both.predict({"x": X})
        tokens = [f.result(timeout=60) for f in gen]
        assert both.ready() and both.state == "ready"
        # a decode worker dead past its budget degrades generate only
        both._on_worker_give_up("decoder")
        with pytest.raises(serving.ServingDegraded, match="decode"):
            both.generate(prompts[0])
        assert both.predict({"x": X})[0].tobytes() == probs.tobytes()
        assert both.ready() and both.state == "degraded"
    with _engine(model_dir) as alone:
        assert alone.predict({"x": X})[0].tobytes() == probs.tobytes()
        with pytest.raises(serving.ServingError, match="decode model"):
            alone.generate(prompts[0])
    with serving.InferenceEngine(
            decode_model=TT.build_decode_model(params, meta, device="cpu"),
            decode_config=cfg, device="cpu") as gen_only:
        for p, t in zip(prompts, tokens):
            assert gen_only.generate(p, timeout=60).tobytes() == t.tobytes()
        with pytest.raises(serving.ServingError, match="no predict model"):
            gen_only.predict({"x": X})


def test_program_backend_multiplies_in_blocks_of_the_smallest_bucket(
        model_dir, monkeypatch):
    """ROADMAP F-6: the Program backend runs each ``mul`` in blocks of
    ``SERVING_BLOCK_ROWS`` rows, at least two, as one batched product, so
    every bucket multiplies blocks of one shape (the smallest bucket's
    rows and every other's fill the same two padded blocks here);
    training executors run one product (``block_rows`` None)."""
    from paddle_tpu_torch.executor import SERVING_BLOCK_ROWS

    assert SERVING_BLOCK_ROWS == 256
    assert fluid.Executor(fluid.CPUPlace()).block_rows is None

    import torch

    shapes = []
    real = torch.bmm

    def counting(a, b):
        shapes.append(tuple(a.shape[:2]))
        return real(a, b)

    with _engine(model_dir, backend="program", batch_buckets=(2, 4, 8)) as eng:
        assert eng._store.block_rows == SERVING_BLOCK_ROWS
        X = np.random.RandomState(3).randn(8, 8).astype("float32")
        alone = eng.predict({"x": X[:2]})[0]
        monkeypatch.setattr(torch, "bmm", counting)
        futs = [eng.predict_async({"x": X[i:i + 2]}) for i in range(0, 8, 2)]
        got = [f.result(timeout=60)[0] for f in futs]
        monkeypatch.undo()
    # two fcs a dispatch, each one product of two 256-row blocks
    assert shapes and set(shapes) == {(2, SERVING_BLOCK_ROWS)}
    assert got[0].tobytes() == alone.tobytes()
