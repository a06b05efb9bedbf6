"""Compute introspection of the port (``observability.xla_stats``) on the
CPU: the count of real executor runs, the MFU and bandwidth gauges, the
``/metrics`` export of the ``compute.*`` families, bitwise neutrality
with the plane armed, the disarmed path, and the counted FLOPs against
torch's own formulas and a hand count, exactly.  The cases of the JAX
package's ``tests/unittests/test_xla_stats.py`` that read no XLA object,
against the port; the JAX package is held beside it for the gauge names
and the MFU formula."""
import os
import tempfile
import urllib.request

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.observability import xla_stats
from paddle_tpu_torch.parallel import flash_attention as fa


@pytest.fixture(autouse=True)
def _plane_off():
    """Every test starts and ends with the plane disarmed and empty, and
    with any peak overrides cleared."""
    xla_stats.disable()
    xla_stats.reset()
    xla_stats.restore_defaults()
    yield
    xla_stats.disable()
    xla_stats.reset()
    xla_stats.restore_defaults()


def _mlp_train_program(seed=3, act="relu", head_act="softmax"):
    main = fluid.Program()
    startup = fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act=act)
        p = fluid.layers.fc(input=h, size=4, act=head_act)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=p, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(16, 8).astype(np.float32),
            "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}
    return main, startup, loss, feed


def _tag(program):
    return "%x:v%d" % (id(program), program.version)


def _run_steps(main, startup, loss, feed, steps=4):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(steps):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return {n: fluid.executor.as_numpy(scope.vars[n])
            for n in main.persistable_names()
            if isinstance(scope.vars.get(n), torch.Tensor)}


def test_capture_populates_gauges_for_bound_training_step():
    xla_stats.enable(peak_flops=1e12, peak_membw=1e11)
    main, startup, loss, feed = _mlp_train_program()
    _run_steps(main, startup, loss, feed, steps=4)

    for name in ("compute.flops_per_step", "compute.peak_hbm_bytes",
                 "compute.mfu", "compute.bw_util"):
        v = obs.gauge(name).value
        assert isinstance(v, float) and v > 0, (name, v)
    st = xla_stats.program_stats(_tag(main))
    assert st is not None
    assert st.flops > 0 and st.bytes_accessed > 0
    assert st.peak_hbm_bytes == st.arg_bytes + st.out_bytes + st.temp_bytes
    # the CPU has no allocator to read; no executable, no code
    assert st.temp_bytes == 0 and st.code_bytes == 0
    # the counted run and the capture are kept out: steps 3 and 4 count
    assert st.steps == 2
    assert 0 < st.last_mfu < 1e3
    assert xla_stats.last_mfu() == st.last_mfu


def test_gauges_visible_in_metrics_scrape_and_summary():
    xla_stats.enable(peak_flops=1e12, peak_membw=1e11)
    main, startup, loss, feed = _mlp_train_program()
    _run_steps(main, startup, loss, feed, steps=3)
    samples = obs.parse_prometheus(obs.render_prometheus(), strict=True)
    for name in ("compute.flops_per_step", "compute.peak_hbm_bytes",
                 "compute.mfu", "compute.bw_util"):
        prom = obs.prometheus_name(name)
        assert prom in samples and samples[prom] > 0, prom
    rep = xla_stats.summary()
    assert "GFLOPs" in rep and "MFU" in rep


def test_bitwise_neutrality_plane_on_vs_off():
    """Arming the plane changes no bit of training: the count rides the
    run the executor makes anyway and touches no state or random
    stream (dropout included)."""
    main, startup, loss, feed = _mlp_train_program(seed=11)
    base = _run_steps(main, startup, loss, feed, steps=5)
    main2, startup2, loss2, feed2 = _mlp_train_program(seed=11)
    xla_stats.enable(peak_flops=1e12, peak_membw=1e11)
    armed = _run_steps(main2, startup2, loss2, feed2, steps=5)
    assert set(base) == set(armed)
    for n in base:
        assert np.array_equal(base[n], armed[n]), n
    assert xla_stats.program_stats() is not None


def test_disabled_path_calls_nothing_of_the_plane(monkeypatch):
    """Disarmed, the executor reads one flag a step and calls nothing of
    the plane (every function patched to raise), op by op and bound."""
    assert not xla_stats.active()

    def boom(*a, **k):
        raise AssertionError("the disarmed executor called the plane")

    for name in ("active", "sync_timing", "capture_step", "counting",
                 "observe_step", "observe_stats", "program_stats",
                 "all_stats", "last_mfu", "tensor_bytes", "device_peaks",
                 "_peaks", "_publish_static", "_drain_clocks"):
        monkeypatch.setattr(xla_stats, name, boom)
    monkeypatch.setattr(xla_stats.DeviceClock, "start", boom)
    monkeypatch.setattr(xla_stats.DeviceClock, "stop", boom)
    monkeypatch.setattr(xla_stats.DeviceClock, "drain", boom)
    main, startup, loss, feed = _mlp_train_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(4):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
            use_program_cache=False)
    assert len(exe._bound) == 1


def test_peak_table_and_overrides(monkeypatch):
    assert xla_stats.device_peaks("NVIDIA H100 80GB HBM3") == (989.4e12,
                                                               3.35e12)
    f, b = xla_stats.device_peaks("weird accelerator")
    assert (f, b) == xla_stats.device_peaks("cpu")  # the cpu row
    monkeypatch.setenv("PADDLE_TPU_TORCH_PEAK_FLOPS", "123.0")
    monkeypatch.setenv("PADDLE_TPU_TORCH_PEAK_MEMBW", "7.0")
    assert xla_stats.device_peaks("NVIDIA H100") == (123.0, 7.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no"):
            xla_stats.device_peaks()


def test_observe_step_derives_mfu_against_pinned_peaks():
    xla_stats.enable(peak_flops=1000.0, peak_membw=500.0)
    main, startup, loss, feed = _mlp_train_program()
    _run_steps(main, startup, loss, feed, steps=3)
    st = xla_stats.program_stats(_tag(main))
    expect = st.flops / st.last_time_s / (1000.0 * st.num_devices)
    assert st.last_mfu == pytest.approx(expect)
    expect_bw = st.bytes_accessed / st.last_time_s / (500.0 * st.num_devices)
    assert st.last_bw_util == pytest.approx(expect_bw)


def test_shape_distinct_entries_keep_their_own_stats():
    """Two feed shapes of one Program bind two entries; each observes on
    its own count, never the tag's newest."""
    xla_stats.enable(peak_flops=1e12, peak_membw=1e11)
    main, startup, loss, feed = _mlp_train_program()
    small = {"x": feed["x"][:4], "y": feed["y"][:4]}
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    for _ in range(2):
        exe.run(main, feed=small, fetch_list=[loss], scope=scope)
    stats = sorted((b.xla["stats"] for b in exe._bound.values()
                    if b.xla and b.xla["stats"] is not None),
                   key=lambda s: -s.flops)
    assert len(stats) == 2
    big_st, small_st = stats
    assert big_st.flops == 4 * small_st.flops   # batch 16 vs 4, GEMMs only
    big_steps, small_steps = big_st.steps, small_st.steps
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert big_st.steps == big_steps + 1
    assert small_st.steps == small_steps


def test_arming_mid_run_skips_the_counted_step():
    """Armed after the entry is bound and captured: the next run is the
    captured step run eagerly under the count, kept out of MFU, and the
    replays then go on (no new capture) and are observed."""
    main, startup, loss, feed = _mlp_train_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert xla_stats.program_stats() is None
    (entry,) = exe._bound.values()
    step = entry.step
    compiles = fluid.executor.compile_count()
    xla_stats.enable(peak_flops=1e12, peak_membw=1e11)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    st = xla_stats.program_stats(_tag(main))
    assert st is not None and st.steps == 0
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert st.steps == 1
    (same,) = exe._bound.values()
    assert same is entry and same.step is step
    assert fluid.executor.compile_count() == compiles


def test_arming_mid_run_is_bitwise():
    main, startup, loss, feed = _mlp_train_program(seed=5)
    base = _run_steps(main, startup, loss, feed, steps=6)
    main2, startup2, loss2, feed2 = _mlp_train_program(seed=5)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup2, scope=scope)
    for i in range(6):
        if i == 3:
            xla_stats.enable()
        exe.run(main2, feed=feed2, fetch_list=[loss2], scope=scope)
    for n, want in base.items():
        assert np.array_equal(fluid.executor.as_numpy(scope.vars[n]),
                              want), n


def test_restore_defaults_clears_override_leak():
    xla_stats.enable(peak_flops=123.0, peak_membw=7.0, sync_timing=True)
    xla_stats.disable()
    assert xla_stats._peaks("NVIDIA H100") == (123.0, 7.0)  # leaks by design
    xla_stats.restore_defaults()
    assert xla_stats._peaks("NVIDIA H100") == (989.4e12, 3.35e12)
    assert not xla_stats.sync_timing()


def test_capture_failure_counts_not_raises(monkeypatch):
    """An operator the count cannot take is counted in
    ``compute.capture_errors``; the step still runs and returns."""
    def broken(*a, **k):
        raise RuntimeError("no formula")

    monkeypatch.setitem(xla_stats.flop_registry, torch.ops.aten.mm, broken)
    errs0 = obs.counter("compute.capture_errors").value
    a = torch.ones(3, 4)
    out, st = xla_stats.capture_step("t", lambda: a @ a.T, "cpu",
                                     arg_values=[a])
    assert st is None
    assert torch.equal(out, torch.full((3, 3), 4.0))
    assert obs.counter("compute.capture_errors").value == errs0 + 1


@pytest.mark.parametrize("shape,causal", [((2, 3, 5, 7, 8), False),
                                          ((1, 2, 16, 16, 4), True)])
def test_flash_flops_equal_sdpa_formulas(shape, causal):
    """B1 and B2 as operators count what ``FlopCounterMode`` gives
    scaled_dot_product_attention forward and backward at the same
    [B, H, T, S, D]: 4·B·H·T·S·D and 10·B·H·T·S·D, masks undiscounted."""
    B, H, T, S, D = shape
    gen = torch.Generator().manual_seed(0)

    def leaves(device):
        return [torch.randn(B, H, n, D, generator=gen).to(device)
                .requires_grad_(True) for n in (T, S, S)]

    q, k, v = leaves("cpu")
    lens = torch.tensor([S] * B, dtype=torch.int32)
    with FlopCounterMode(display=False) as ours:
        fa.flash_attention(q, k, v, kv_lens=lens, causal=causal).sum()\
            .backward()
    q, k, v = leaves("meta")
    with FlopCounterMode(display=False) as sdpa:
        out = torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True, 0.0, causal)[0]
        out.backward(torch.ones_like(out))
    assert ours.get_total_flops() == sdpa.get_total_flops() \
        == 14 * B * H * T * S * D
    counts = ours.get_flop_counts()["Global"]
    assert counts[torch.ops.paddle_tpu_torch.flash_fwd] == 4 * B * H * T * S * D
    assert counts[torch.ops.paddle_tpu_torch.flash_bwd] == 10 * B * H * T * S * D
    # the plane's own count of the same call
    q, k, v = leaves("cpu")
    _, st = xla_stats.capture_step(
        "flash", lambda: fa.flash_attention(q, k, v, causal=causal).sum()
        .backward(), "cpu", register=False)
    assert st.flops == 14 * B * H * T * S * D


def test_fc_program_flops_are_the_hand_count():
    """An fc-only Program: the count is 2·M·N·K over its forward GEMMs
    and the backward's (dX and dW of the second layer, dW of the first,
    whose input is a feed), exactly."""
    xla_stats.enable()
    main, startup = fluid.Program(), fluid.Program()
    M, K, N1, N2 = 12, 8, 16, 4
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[K], dtype="float32")
        h = fluid.layers.fc(input=x, size=N1)
        p = fluid.layers.fc(input=h, size=N2)
        loss = fluid.layers.mean(p)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    feed = {"x": np.random.RandomState(0).randn(M, K).astype(np.float32)}
    _run_steps(main, startup, loss, feed, steps=1)
    st = xla_stats.program_stats(_tag(main))
    gemm = lambda m, n, k: 2 * m * n * k  # noqa: E731
    want = (gemm(M, N1, K) + gemm(M, N2, N1)        # forward
            + gemm(M, N1, N2) + gemm(N1, N2, M)     # dX2, dW2
            + gemm(K, N1, M))                       # dW1
    assert st.flops == want
    assert st.op_rows["mul"]["instructions"] >= 2
    assert st.op_rows["backward"]["instructions"] >= 3


def test_gauge_names_and_mfu_formula_match_the_jax_package():
    pytest.importorskip("jax")
    from paddle_tpu.observability import xla_stats as jxs

    assert xla_stats.GAUGES == jxs.GAUGES
    vals = dict(flops=3.0e9, bytes_accessed=2.0e8, arg_bytes=1e6,
                out_bytes=2e6, temp_bytes=3e6, alias_bytes=0.0,
                code_bytes=0.0, num_devices=1, device_kind="cpu")
    xla_stats.configure_peaks(5e12, 4e11)
    jxs.configure_peaks(5e12, 4e11)
    try:
        ours, theirs = xla_stats.ProgramStats("t", **vals), \
            jxs.ProgramStats("t", **vals)
        assert xla_stats.observe_stats(ours, 0.0125) == \
            jxs.observe_stats(theirs, 0.0125)
        assert ours.last_bw_util == theirs.last_bw_util
        assert ours.peak_hbm_bytes == theirs.peak_hbm_bytes
        assert ours.arith_intensity == theirs.arith_intensity
        assert set(ours.as_dict()) == set(theirs.as_dict())
    finally:
        jxs.configure_peaks(None, None)
        jxs.reset()


def test_trainer_records_carry_mfu():
    xla_stats.enable(peak_flops=1e12, peak_membw=1e11)

    def train_func():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        return fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(5):
            x = rng.randn(8, 4).astype("float32")
            yield list(zip(x, x[:, :1]))

    ring = obs.RingBufferSink()
    obs.add_sink(ring)
    try:
        t = fluid.Trainer(train_func,
                          lambda: fluid.optimizer.SGD(learning_rate=0.05),
                          place=fluid.CPUPlace())
        t.train(num_epochs=1, reader=reader, feed_order=["x", "y"])
    finally:
        obs.remove_sink(ring)
    recs = [r for r in ring.records if r.get("source") == "trainer"]
    assert len(recs) == 5
    mfus = [r.get("mfu") for r in recs]
    assert mfus[:2] == [None, None]   # the count, then the capture
    assert all(isinstance(m, float) and m > 0 for m in mfus[2:])
    execs = [r for r in ring.records if r.get("source") == "executor"]
    assert all(isinstance(r["execute_s"], float) for r in execs)


def _save_model(dirname, seed=5, width=8):
    main = fluid.Program()
    startup = fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[width], dtype="float32")
        out = fluid.layers.fc(x, size=4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                      main_program=main)
    return dirname


def test_pool_serve_metrics_exports_compute_families():
    """The compute.* families ride a ReplicaPool's /metrics endpoint, and
    the exposition stays free of duplicate families."""
    xla_stats.enable(peak_flops=1e12, peak_membw=1e11)
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as td:
        mdir = _save_model(os.path.join(td, "m"))
        pool = serving.ReplicaPool(mdir, replicas=2, devices=["cpu"],
                                   batch_buckets=(2, 4),
                                   batch_timeout_ms=0.5, warmup=False,
                                   supervise=False)
        try:
            for _ in range(6):
                pool.predict({"x": rng.randn(1, 8).astype(np.float32)},
                             timeout=60)
            srv = pool.serve_metrics()
            with urllib.request.urlopen(srv.url + "/metrics",
                                        timeout=5) as resp:
                body = resp.read().decode()
        finally:
            pool.stop()
    samples = obs.parse_prometheus(body, strict=True)
    for name in ("compute.flops_per_step", "compute.peak_hbm_bytes",
                 "compute.mfu", "compute.bw_util"):
        prom = obs.prometheus_name(name)
        assert prom in samples and samples[prom] > 0, prom
    assert obs.prometheus_name("serving.replica.pool_size") in samples
