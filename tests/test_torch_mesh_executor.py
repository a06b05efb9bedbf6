"""The executor's mesh step on the CPU: dp, dp x tp, pure tp, ZeRO and
``Trainer(zero_stage=)`` against the JAX package's ``ParallelExecutor`` on
its 8 CPU devices (``tests/conftest.py``), from the same numpy state and
batches (both packages build the same Program JSON).

The cases of ``tests/unittests/test_parallel_executor.py`` and
``test_zero_sharding.py``, with their limits: losses within 1e-5
relative (1e-6 absolute; the Transformer 2e-4), the first weight within
1e-5 relative (dp x tp 1e-4) and 1e-6 absolute.  The port's ranks are
``["cpu"] * n``.  Each state value's layout (``Executor.state_specs``)
is the JAX package's ``.sharding.spec`` with trailing Nones dropped, and
``plan_feed_shardings`` gives the JAX package's feed specs.  Port against
port: a one-rank mesh is bitwise ``Executor.run``, two runs of a 4-rank
step are bitwise, the bound step bitwise its op-by-op steps.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.parallel.sharded import ShardedTensor
from paddle_tpu_torch.reader import device_prefetch

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
W_RTOL, W_ATOL = 1e-5, 1e-6


def _mlp(fl, opt="sgd", y_dtype="int64"):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype=y_dtype)
        h = L.fc(input=x, size=16, act="relu")
        if y_dtype == "int64":
            p = L.fc(input=h, size=4, act="softmax")
            loss = L.mean(L.cross_entropy(input=p, label=y))
        else:
            loss = L.mean(L.square_error_cost(L.fc(h, size=1), y))
        (fl.optimizer.SGD(learning_rate=0.1) if opt == "sgd"
         else fl.optimizer.Adam(learning_rate=0.05)).minimize(loss)
    return main, startup, loss


def _batch(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 8).astype("float32"),
            "y": rng.randint(0, 4, size=(n, 1)).astype("int64")}


def _start(build, seed):
    """Both packages' Programs (asserted the same JSON) and the port's
    startup state from ``seed``, copied into a JAX scope."""
    jm, _, jloss = build(jfluid)
    tm, ts, tloss = build(tfluid)
    assert jm.to_string() == tm.to_string()
    ts.random_seed = seed
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(ts, scope=tscope)
    state = {n: np.array(tscope[n]) for n in tm.persistable_names()
             if n in tscope and tscope[n] is not None}
    return jm, jloss, tm, tloss, state


def _scope(fl, state):
    s = fl.Scope()
    for n, v in state.items():
        s[n] = v
    return s


def _jax_steps(jm, jloss, state, feed, steps, mesh, **pe):
    scope = _scope(jfluid, state)
    with jfluid.scope_guard(scope):
        pexe = jfluid.ParallelExecutor(loss_name=jloss.name, main_program=jm,
                                       mesh_shape=mesh, **pe)
        losses = [float(np.ravel(pexe.run(fetch_list=[jloss], feed=feed)[0]).mean())
                  for _ in range(steps)]
    return losses, scope, pexe


def _port_steps(tm, tloss, state, feed, steps, mesh=None, ranks=None, **pe):
    scope = _scope(tfluid, state)
    if mesh is None:
        exe = tfluid.Executor(tfluid.CPUPlace())
        losses = [np.asarray(exe.run(tm, feed=feed, fetch_list=[tloss],
                                     scope=scope)[0]) for _ in range(steps)]
        return losses, scope, exe
    pexe = tfluid.ParallelExecutor(loss_name=tloss.name, main_program=tm,
                                   mesh_shape=mesh, scope=scope,
                                   devices=["cpu"] * ranks, **pe)
    losses = [np.asarray(pexe.run(fetch_list=[tloss], feed=feed)[0])
              for _ in range(steps)]
    return losses, scope, pexe


def _floats(losses):
    return [float(np.ravel(v)[0]) for v in losses]


def _jspecs(scope):
    return {n: _trim(tuple(v.sharding.spec)) for n, v in scope.vars.items()
            if hasattr(getattr(v, "sharding", None), "spec")}


def _trim(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


MESH_CASES = {
    # test_parallel_matches_single_device, test_parallel_executor_dp_tp_
    # mesh_matches_single_device, test_parallel_executor_pure_tp_mesh_
    # without_dp_axis; ZeRO (test_zero_matches_unsharded_numerics,
    # test_zero_composes_with_tensor_parallel)
    "dp8": (True, 8, {}, "sgd", W_RTOL),
    "dp4_tp2": ((4, 2), 8, {}, "sgd", 1e-4),
    "tp2": ({"tp": 2}, 2, {}, "sgd", W_RTOL),
    "zero1_dp4": ({"dp": 4}, 4, {"zero_stage": 1}, "adam", W_RTOL),
    "zero3_dp4": ({"dp": 4}, 4, {"zero_stage": 3}, "adam", W_RTOL),
    "zero1_dp4_tp2": ({"dp": 4, "tp": 2}, 8, {"zero_stage": 1}, "adam", W_RTOL),
    "zero3_dp4_tp2": ({"dp": 4, "tp": 2}, 8, {"zero_stage": 3}, "adam", W_RTOL),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_step_matches_jax(case):
    """Four steps over the mesh against the JAX package's: the losses, the
    first weight, and every state value's layout (its spec)."""
    mesh, ranks, pe, opt, w_rtol = MESH_CASES[case]
    jm, jloss, tm, tloss, state = _start(lambda fl: _mlp(fl, opt), 21)
    feed = _batch(seed=len(case))
    want, jscope, _ = _jax_steps(jm, jloss, state, feed, 4, mesh, **pe)
    got, tscope, pexe = _port_steps(tm, tloss, state, feed, 4, mesh, ranks, **pe)
    assert pexe.device_count == ranks
    np.testing.assert_allclose(_floats(got), want, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(np.array(tscope["fc_0.w_0"]),
                               np.asarray(jscope["fc_0.w_0"]), rtol=w_rtol,
                               atol=W_ATOL)
    jspecs = _jspecs(jscope)
    tspecs = pexe._exe.state_specs(tscope, tm)
    assert {n: jspecs.get(n, ()) for n in tspecs} == tspecs
    if pe.get("zero_stage"):
        moments = [n for n in tspecs if "_moment" in n]
        assert moments and all("dp" in tspecs[n] for n in moments)
        assert all("dp" not in s for n, s in tspecs.items() if "_pow_acc" in n)
        assert ("dp" in tspecs["fc_0.w_0"]) == (pe["zero_stage"] >= 3)


def test_each_rank_holds_a_quarter_under_zero_3():
    jm, jloss, tm, tloss, state = _start(lambda fl: _mlp(fl, "adam"), 21)
    feed = _batch(seed=1)
    by_stage = {}
    for stage in (0, 1, 3):
        _, scope, pexe = _port_steps(tm, tloss, state, feed, 1, {"dp": 4}, 4,
                                     zero_stage=stage)
        per_rank = pexe._exe.rank_state_bytes(scope, tm)
        assert len(set(per_rank)) == 1
        by_stage[stage] = per_rank[0]
    full = sum(v.nbytes for v in state.values())
    assert by_stage[0] == full
    assert by_stage[3] < by_stage[1] < by_stage[0]
    assert by_stage[3] <= 0.3 * full


def test_plan_feed_shardings_matches_jax():
    jm, _, tm, _, state = _start(_mlp, 3)
    feeds = {"x": np.zeros((32, 8), np.float32),
             "y": np.zeros((30, 1), np.int64),       # 30 % 8: replicated
             "not_data": np.zeros((32, 2), np.float32)}
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.attach_mesh({"dp": 8})
    want = {n: _trim(tuple(s.spec)) for n, s in
            jexe.plan_feed_shardings(jm, feeds).items()}
    texe = tfluid.Executor(tfluid.CPUPlace())
    assert texe.plan_feed_shardings(tm, feeds) is None
    texe.attach_mesh({"dp": 8}, devices=["cpu"] * 8)
    got = texe.plan_feed_shardings(tm, feeds)
    assert got == want == {"x": ("dp",), "y": (), "not_data": ()}


def test_dp_tp_transformer_matches_jax():
    """test_parallel_executor.py::test_parallel_executor_dp_tp_transformer_
    matches_replicated: three Adam steps over dp 4 x tp 2, each loss
    within 2e-4 of the JAX package's."""
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch.models import transformer as TT

    B, S = 8, 16
    kw = dict(batch_size=B, seq_len=S, src_vocab_size=64, trg_vocab_size=64,
              max_length=S + 2, n_layer=1, n_head=2, d_model=16, d_inner=32,
              dropout=0.0)

    def build(fl):
        T = JT if fl is jfluid else TT
        with fl.unique_name.guard():
            m = T.get_model(**kw)
        return m["main"], m["startup"], m["loss"]

    jm, jloss, tm, tloss, state = _start(build, 9)
    rng = np.random.RandomState(3)
    feed = {n: rng.randint(1, 64, size=(B, S)).astype("int64")
            for n in ("src_word", "trg_word", "lbl_word")}
    want, _, _ = _jax_steps(jm, jloss, state, feed, 3, (4, 2))
    got, _, _ = _port_steps(tm, tloss, state, feed, 3, (4, 2), 8)
    np.testing.assert_allclose(_floats(got), want, rtol=2e-4, atol=1e-6)


def _flash_tf(dropout=0.0):
    from paddle_tpu_torch.models import transformer as TT

    with tfluid.unique_name.guard():
        m = TT.get_model(batch_size=4, seq_len=8, src_vocab_size=32,
                         trg_vocab_size=32, max_length=8, n_layer=1, n_head=2,
                         d_model=16, d_inner=32, dropout=dropout, use_flash=True)
    m["startup"].random_seed = m["main"].random_seed = 5
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(m["startup"], scope=scope)
    state = {n: np.array(scope[n]) for n in m["main"].persistable_names()
             if n in scope}
    rng = np.random.RandomState(2)
    feed = {n: rng.randint(3, 32, size=(4, 8)).astype("int64")
            for n in ("src_word", "trg_word", "lbl_word")}
    return m, state, feed


def test_two_runs_of_a_4_rank_step_are_bitwise():
    """dp 2 x tp 2 of the flash Transformer: two runs from one state give
    the same bits, the bound step the bits of its op-by-op steps, and
    each of the layer's three flash attentions takes the rows path (its
    rule runs once a dp rank, on that rank's rows)."""
    from paddle_tpu_torch import mesh_step

    m, state, feed = _flash_tf()
    runs = []
    for fast in (True, True, False):
        scope = _scope(tfluid, state)
        pexe = tfluid.ParallelExecutor(loss_name=m["loss"].name,
                                       main_program=m["main"], scope=scope,
                                       mesh_shape=(2, 2), devices=["cpu"] * 4)
        pexe.fast_path = fast
        losses = [np.asarray(pexe.run(fetch_list=[m["loss"]], feed=feed)[0])
                  .tobytes() for _ in range(3)]
        runs.append((losses, {n: np.array(scope[n]).tobytes() for n in state}))
        assert len(pexe._exe._bound) == (1 if fast else 0)
    assert runs[0] == runs[1] == runs[2]
    # the attention runs once a dp rank: a one-step trace of the paths
    seen = []
    orig = mesh_step.MeshRun._rows

    def spy(self, ctx, op, *a):
        ok = orig(self, ctx, op, *a)
        seen.append((op.type, ok))
        return ok
    mesh_step.MeshRun._rows = spy
    try:
        pexe = tfluid.ParallelExecutor(loss_name=m["loss"].name,
                                       main_program=m["main"],
                                       scope=_scope(tfluid, state),
                                       mesh_shape=(2, 2), devices=["cpu"] * 4)
        pexe.fast_path = False
        pexe.run(fetch_list=[m["loss"]], feed=feed)
    finally:
        mesh_step.MeshRun._rows = orig
    flash = [ok for t, ok in seen if t == "flash_attention"]
    assert flash == [True] * 3


def test_a_one_rank_mesh_is_bitwise_executor_run():
    m, state, feed = _flash_tf(dropout=0.1)
    out = []
    for mesh in (None, {"dp": 1}):
        scope = _scope(tfluid, state)
        exe = tfluid.Executor(tfluid.CPUPlace())
        if mesh:
            exe.attach_mesh(mesh, devices=["cpu"])
        out.append([np.asarray(exe.run(m["main"], feed=feed,
                                       fetch_list=[m["loss"]], scope=scope)[0])
                    .tobytes() for _ in range(3)])
    assert out[0] == out[1]


def _dropout_mlp(fl):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[8], dtype="float32")
        d = L.dropout(x, dropout_prob=0.3)
        loss = L.mean(L.fc(input=d, size=4))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, d, loss


@pytest.mark.parametrize("mesh, ranks", [({"dp": 2}, 2), ((2, 2), 4)],
                         ids=["dp2", "dp2_tp2"])
def test_dropout_over_dp_draws_executor_runs_mask(mesh, ranks):
    """Dropout on a batch split over dp draws ``Executor.run``'s mask over
    the whole batch (not one rank's mask repeated on every rank): three
    steps, the dropout's output bitwise, the losses and weights within
    LOSS_* and W_* of ``Executor.run``'s."""
    main, startup, d, loss = _dropout_mlp(tfluid)
    main.random_seed = startup.random_seed = 4
    s0 = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=s0)
    state = {n: np.array(s0[n]) for n in main.persistable_names()}
    feed = {"x": np.random.RandomState(6).randn(16, 8).astype("float32")}
    runs = []
    for m in (None, mesh):
        scope = _scope(tfluid, state)
        exe = tfluid.Executor(tfluid.CPUPlace())
        if m:
            exe.attach_mesh(m, devices=["cpu"] * ranks)
        outs = [[np.asarray(v) for v in exe.run(main, feed=feed, scope=scope,
                                                 fetch_list=[d, loss])]
                for _ in range(3)]
        runs.append((outs, {n: np.array(scope[n]) for n in state}))
    (want, wstate), (got, gstate) = runs
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.tobytes() == wd.tobytes()
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for n in state:
        np.testing.assert_allclose(gstate[n], wstate[n], rtol=W_RTOL, atol=W_ATOL)


def test_dp_transformer_with_dropout_matches_executor_run():
    """The flash Transformer at dropout 0.1 over dp 2: three steps, each
    loss within LOSS_* and every state value within W_* of
    ``Executor.run``'s from the same state."""
    m, state, feed = _flash_tf(dropout=0.1)
    runs = []
    for mesh in (None, {"dp": 2}):
        scope = _scope(tfluid, state)
        exe = tfluid.Executor(tfluid.CPUPlace())
        if mesh:
            exe.attach_mesh(mesh, devices=["cpu"] * 2)
        losses = [np.asarray(exe.run(m["main"], feed=feed, scope=scope,
                                     fetch_list=[m["loss"]])[0])
                  for _ in range(3)]
        runs.append((_floats(losses), {n: np.array(scope[n]) for n in state}))
    (want, wstate), (got, gstate) = runs
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for n in state:
        np.testing.assert_allclose(gstate[n], wstate[n], rtol=W_RTOL, atol=W_ATOL)


def test_shard_feed_list_places_each_entry_on_its_rank():
    """Per-rank feed dicts over dp 8: each data var's entries on their
    ranks' devices (one transfer an entry), the global batch split on its
    rows; the steps are those of the merged dict, bitwise."""
    feed = _batch(32, seed=3)
    parts = [{k: v[i * 4:(i + 1) * 4] for k, v in feed.items()} for i in range(8)]
    main, startup, loss = _mlp(tfluid)
    startup.random_seed = 9
    state_scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=state_scope)
    state = {n: np.array(state_scope[n]) for n in main.persistable_names()}
    runs = []
    for fed in (parts, feed):
        pexe = tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                       scope=_scope(tfluid, state),
                                       devices=["cpu"] * 8)
        if fed is parts:
            t0 = device_prefetch.transfer_count()
            placed = device_prefetch.shard_feed_list(parts, pexe._mesh,
                                                     pexe._data_names(), main)
            assert device_prefetch.transfer_count() - t0 == 16
            assert isinstance(placed["x"], ShardedTensor)
            assert placed["x"].spec == ("dp", None) and len(placed["x"].blocks) == 8
            assert np.array_equal(np.array(placed["x"]), feed["x"])
        runs.append([np.asarray(pexe.run(fetch_list=[loss], feed=fed)[0]).tobytes()
                     for _ in range(3)])
    assert runs[0] == runs[1]
    # another mesh, or none, concatenates on the host (the JAX package's rule)
    mesh = tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                   scope=_scope(tfluid, state),
                                   devices=["cpu"] * 4, mesh_shape=(2, 2))._mesh
    for m in (mesh, None):
        got = device_prefetch.shard_feed_list(parts[:2], m, {"x", "y"})
        assert isinstance(got["x"], np.ndarray) and len(got["x"]) == 8


def test_trainer_zero_stage():
    """test_zero_sharding.py::test_trainer_zero_stage: Trainer(parallel=
    {dp 8}, zero_stage=1) over eight ranks named by ``devices=`` trains,
    the Adam moments split over dp in the trainer's scope; its steps are
    those of a Trainer without ZeRO, bitwise."""
    def train_func():
        L = tfluid.layers
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(x, size=16, act="relu")
        return L.mean(L.square_error_cost(L.fc(h, size=1), y))

    rng = np.random.RandomState(2)
    X = rng.randn(32, 8).astype("float32")
    Y = rng.randn(32, 1).astype("float32")

    def run(**kw):
        np.random.seed(11)  # the startup's seed: one start state for both
        t = tfluid.Trainer(train_func,
                           lambda: tfluid.optimizer.Adam(learning_rate=0.05),
                           place=tfluid.CPUPlace(), **kw)
        losses = []
        t.train(num_epochs=1, reader=lambda: iter([list(zip(X, Y))] * 4),
                feed_order=["x", "y"],
                event_handler=lambda e: losses.append(
                    float(np.ravel(e.metrics[0])[0]))
                if isinstance(e, tfluid.EndStepEvent) else None)
        return t, losses

    t, losses = run(parallel={"dp": 8}, zero_stage=1, devices=["cpu"] * 8)
    assert len(losses) == 4 and losses[-1] < losses[0]
    specs = t.exe.state_specs(t.scope)
    assert any("_moment" in n and "dp" in s for n, s in specs.items()), specs
    _, plain = run()
    np.testing.assert_allclose(losses, plain, rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_a_step_that_creates_a_persistable_runs_on_a_mesh():
    """test_mesh_runner_out_pinning_fallback_on_step_created_persistable:
    a persistable the startup never initialized lands in the scope with
    the step's value, and the next run (state now holding it) binds."""
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = L.data(name="x", shape=[8], dtype="float32")
        s = L.reduce_sum(L.fc(input=x, size=4))
        acc = main.global_block().create_var(name="step_sum_acc", shape=[1],
                                             dtype="float32", persistable=True)
        L.assign(s, output=acc)
    startup.random_seed = 3
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    X = np.random.RandomState(0).randn(16, 8).astype("float32")
    pexe = tfluid.ParallelExecutor(main_program=main, scope=scope,
                                   devices=["cpu"] * 8)
    (v1,) = pexe.run(fetch_list=[s], feed={"x": X})
    assert abs(float(np.ravel(np.array(scope["step_sum_acc"]))[0])
               - float(np.ravel(v1)[0])) < 1e-3
    (v2,) = pexe.run(fetch_list=[s], feed={"x": X})
    (v3,) = pexe.run(fetch_list=[s], feed={"x": X})
    np.testing.assert_allclose(np.ravel(v3), np.ravel(v1), rtol=1e-5)
    assert len(pexe._exe._bound) == 1


def test_attach_mesh_drops_what_was_bound_before():
    """test_attach_mesh_invalidates_compiled_cache: after attach_mesh({dp
    8}) the next run binds again, and the weight carries its layout."""
    main, startup, loss = _mlp(tfluid)
    startup.random_seed = 5
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    X = _batch(16, seed=1)
    (v1,) = exe.run(main, feed=X, fetch_list=[loss], scope=scope)
    assert len(exe._bound) == 1
    exe.attach_mesh({"dp": 8}, sharding_rules=[("fc_0.w_0", (None, "dp"))],
                    devices=["cpu"] * 8)
    assert len(exe._bound) == 0
    exe.run(main, feed=X, fetch_list=[loss], scope=scope)
    assert exe.state_specs(scope, main)["fc_0.w_0"] == ()  # no tp axis
    exe.attach_mesh((4, 2), sharding_rules=[("fc_0.w_0", (None, "tp"))],
                    devices=["cpu"] * 8)
    exe.run(main, feed=X, fetch_list=[loss], scope=scope)
    assert exe.state_specs(scope, main)["fc_0.w_0"] == (None, "tp")
    assert isinstance(scope.vars["fc_0.w_0"], ShardedTensor)
    # an Executor without a mesh reads the same scope as whole tensors
    plain = tfluid.Executor(tfluid.CPUPlace())
    plain.run(main, feed=X, fetch_list=[loss], scope=scope)
    assert isinstance(scope.vars["fc_0.w_0"], torch.Tensor)


def test_nan_guard_holds_the_state_on_a_mesh():
    main, startup, loss = _mlp(tfluid, "adam")
    startup.random_seed = 7
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.attach_mesh({"dp": 4}, zero_stage=3, devices=["cpu"] * 4)
    feed = _batch(16, seed=2)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope, nan_guard=True)
    assert exe.last_step_ok() is True
    before = {n: np.array(scope[n]) for n in main.persistable_names()}
    bad = dict(feed, x=np.full_like(feed["x"], np.nan))
    exe.run(main, feed=bad, fetch_list=[loss], scope=scope, nan_guard=True)
    assert exe.last_step_ok() is False
    after = {n: np.array(scope[n]) for n in main.persistable_names()}
    assert all(before[n].tobytes() == after[n].tobytes() for n in before)
