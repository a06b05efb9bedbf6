"""The port's executor fast path on the CPU: bound programs, lazy fetches,
the counters, ``JitStepCache``, ``nan_guard`` and the ``reads_host`` mark.

The cases of ``tests/unittests/test_executor_fast_path.py`` that apply to
the port, ported: the fast path must be invisible (the same bits as the
slow path, port against port), invalidated by exactly the events that can
change a step (a program edit, a scope mutation, a feed of another shape),
and never hand out a fetch that a later step changes.  Small sizes: an
MLP of 3 fc layers of width 8, and a 1+1-layer Transformer at d_model 32
handed over from the JAX package as its Program JSON.

Against the JAX package, on the same Program and numpy parameters: the
fast path's MLP and dropout-free Transformer losses within LOSS_RTOL
(the packages sum in different orders), and ``nan_guard``'s verdicts
exactly, with the guarded parameters within PARAM_RTOL.  On the CPU a
bound entry's captured step runs as it is, on the same static buffers
and state updated in place as the card's CUDA graph; the replay of the
same entries is held bitwise to the op-by-op path on the card by
chip_smoke.py's fast-path phase.
"""
import ast
import gc
import inspect
import sys
import textwrap
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import executor as texe
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch import registry as treg
from paddle_tpu_torch.executor import JitStepCache, LazyFetch, _BoundProgram
from paddle_tpu_torch.lod import LoDArray
from paddle_tpu_torch.models import transformer as TT

CPU = tfluid.CPUPlace()
LOSS_RTOL = 1e-5    # port vs JAX: float32 sums in another order
PARAM_RTOL = 1e-5   # the same, one SGD step's parameters
TINY = dict(batch_size=2, seq_len=16, src_vocab_size=60, trg_vocab_size=60,
            max_length=16, n_layer=1, n_head=2, d_model=32, d_inner=64,
            use_flash=True)


def _mlp(fl, n_layers=3, width=8, seed=77):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard():
        with fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[width], dtype="float32")
            y = fl.layers.data(name="y", shape=[1], dtype="float32")
            h = x
            for _ in range(n_layers):
                h = fl.layers.fc(h, size=width, act="relu")
            pred = fl.layers.fc(h, size=1)
            loss = fl.layers.mean(fl.layers.square(pred - y))
            fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.random_seed = seed
    return main, startup, loss


def _feed(width=8, batch=4, seed=3):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, width).astype(np.float32),
            "y": rng.randn(batch, 1).astype(np.float32)}


def _params(main, scope):
    return {n: np.array(scope[n]) for n in sorted(main.persistable_names())
            if n in scope}


def _run_steps(main, startup, loss, feeds, use_program_cache, np_seed=11,
               state=None):
    """A fresh scope and executor, startup (or ``state`` loaded), then a
    step a feed; returns (losses, params, executor, compiles)."""
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    losses = []
    with tfluid.scope_guard(scope):
        np.random.seed(np_seed)
        if state is None:
            exe.run(startup)
        else:
            tfluid.load_numpy_state(main, state, device="cpu")
        before = texe.compile_count()
        for feed in feeds:
            out = exe.run(main, feed=feed, fetch_list=[loss],
                          use_program_cache=use_program_cache)
            losses.append(np.array(out[0]))
        compiles = texe.compile_count() - before
        params = _params(main, scope)
    return losses, params, exe, compiles


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for n in a:
        assert np.asarray(a[n]).tobytes() == np.asarray(b[n]).tobytes(), n


def _bound(exe):
    return [b for b in exe._bound.values() if isinstance(b, _BoundProgram)]


# ---------------------------------------------------------------------------
# bitwise: fast against slow
# ---------------------------------------------------------------------------


def test_fast_path_bitwise_equal_training():
    main, startup, loss = _mlp(tfluid)
    feeds = [_feed()] * 8
    lf, pf, exe, compiles = _run_steps(main, startup, loss, feeds, True)
    ls, ps, _, slow_compiles = _run_steps(main, startup, loss, feeds, False)
    assert _bound(exe), "the fast path never bound the program"
    # one capture (the entry's second run); the slow path builds none
    assert (compiles, slow_compiles) == (1, 0)
    _assert_bitwise(pf, ps)
    for a, b in zip(lf, ls):
        assert a.tobytes() == b.tobytes()


def test_fast_path_training_matches_jax():
    """The MLP handed over as the JAX package's Program JSON, from its
    startup state: the port's fast path against the JAX package's."""
    jmain, jstart, jloss = _mlp(jfluid, seed=5)
    feeds = [_feed(seed=s) for s in range(6)]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        np.random.seed(7)
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        state = {n: np.asarray(jscope[n]) for n in jmain.persistable_names()
                 if n in jscope}
        want = [float(np.asarray(exe.run(jmain, feed=f,
                                         fetch_list=[jloss])[0]))
                for f in feeds]
        jparams = {n: np.asarray(jscope[n]) for n in state}
    main = tfluid.Program.parse_from_string(jmain.to_string())
    got, params, exe, _ = _run_steps(main, None, jloss.name, feeds, True,
                                     state=state)
    assert _bound(exe)
    np.testing.assert_allclose([float(v) for v in got], want,
                               rtol=LOSS_RTOL, atol=0)
    for n, v in jparams.items():
        np.testing.assert_allclose(params[n], v, rtol=PARAM_RTOL,
                                   atol=PARAM_RTOL, err_msg=n)


def _transformer_feeds(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {k: rng.randint(3, 60, size=(2, 16)).astype("int64")
             for k in ("src_word", "trg_word", "lbl_word")}
        f["src_word"][0, 12:] = 0
        f["trg_word"][1, 9:] = 0
        f["lbl_word"][1, 9:] = 0
        out.append(f)
    return out


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_transformer_fast_path_through_program_json(dropout):
    """Transformer-base at 1+1 layers, d_model 32, built by the JAX
    package and handed over as its Program JSON: four Adam steps on the
    fast path equal the slow path bitwise (dropout 0.1 draws the same
    bits on both), and without dropout the losses match the JAX
    package's within LOSS_RTOL."""
    with jfluid.unique_name.guard():
        jm = JT.get_model(dropout=dropout, **TINY)
    jm["main"].random_seed = 19
    feeds = _transformer_feeds(4)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jm["startup"])
        state = {n: np.asarray(jscope[n])
                 for n in jm["main"].persistable_names() if n in jscope}
        want = [float(np.ravel(exe.run(jm["main"], feed=f,
                                       fetch_list=[jm["loss"]])[0])[0])
                for f in feeds]
    main = tfluid.Program.parse_from_string(jm["main"].to_string())
    loss = jm["loss"].name
    lf, pf, exe, compiles = _run_steps(main, None, loss, feeds, True,
                                       state=state)
    ls, ps, _, _ = _run_steps(main, None, loss, feeds, False, state=state)
    assert _bound(exe) and compiles == 1
    _assert_bitwise(pf, ps)
    assert [a.tobytes() for a in lf] == [b.tobytes() for b in ls]
    if dropout == 0.0:
        np.testing.assert_allclose([float(np.ravel(v)[0]) for v in lf],
                                   want, rtol=LOSS_RTOL, atol=0)


def test_feed_shapes_in_turn_share_state_and_capture_once_each():
    """Batch sizes in turn through one executor, as chip_smoke.py's shape
    cycle runs them on the card: a new size's first run (op by op) writes
    the state buffers of the earlier captures in place, so that each size
    is captured once and stays bound; the losses and the state equal the
    same sequence op by op, bitwise."""
    main, startup, loss = _mlp(tfluid, seed=17)
    sizes = (4, 4, 4, 6, 6, 3, 3, 4, 6, 3)
    feeds = [_feed(batch=b, seed=i) for i, b in enumerate(sizes)]
    lf, pf, exe, compiles = _run_steps(main, startup, loss, feeds, True)
    ls, ps, _, _ = _run_steps(main, startup, loss, feeds, False)
    assert compiles == 3
    assert sorted(b.static_feeds["x"].shape[0] for b in _bound(exe)
                  if b.program is main and b.step is not None) == [3, 4, 6]
    _assert_bitwise(pf, ps)
    assert [a.tobytes() for a in lf] == [b.tobytes() for b in ls]


def test_cache_hit_matches_cold_run():
    main, startup, loss = _mlp(tfluid, seed=13)
    test_prog = main.clone(for_test=True)
    feed = _feed(seed=5)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(23)
        exe.run(startup)
        warm = [np.asarray(exe.run(test_prog, feed=feed, fetch_list=[loss])[0])
                for _ in range(4)]
        cold_exe = tfluid.Executor(CPU)
        cold = np.asarray(cold_exe.run(test_prog, feed=feed, fetch_list=[loss],
                                       use_program_cache=False)[0])
    for w in warm:
        assert w.tobytes() == cold.tobytes()


# ---------------------------------------------------------------------------
# invalidation
# ---------------------------------------------------------------------------


def test_scope_mutation_invalidates_bound_entry():
    main, startup, loss = _mlp(tfluid, seed=21)
    test_prog = main.clone(for_test=True)
    feed = _feed(seed=9)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(31)
        exe.run(startup)
        for _ in range(3):
            before = np.asarray(exe.run(test_prog, feed=feed,
                                        fetch_list=[loss])[0])
        (key, bound), = [(k, v) for k, v in exe._bound.items()
                         if isinstance(v, _BoundProgram)]
        pname = sorted(n for n in test_prog.persistable_names()
                       if n in scope and ".w_" in n)[0]
        scope[pname] = np.zeros_like(np.asarray(scope[pname]))
        after = np.asarray(exe.run(test_prog, feed=feed, fetch_list=[loss])[0])
        assert after.tobytes() != before.tobytes()
        assert exe._bound[key] is not bound, "scope mutation did not rebind"
        # the shim surface invalidates too
        bound2 = exe._bound[key]
        t = scope.find_var(pname).get_tensor()
        t.set(np.ones(t.shape(), np.float32))
        out2 = np.asarray(exe.run(test_prog, feed=feed, fetch_list=[loss])[0])
        assert out2.tobytes() != after.tobytes()
        assert exe._bound[key] is not bound2


@pytest.mark.parametrize("mutate", ["setitem", "var", "set", "drop_kids",
                                    "drop"])
def test_every_scope_mutator_bumps_the_version(mutate):
    scope = tfluid.Scope()
    scope["w"] = np.zeros(2, np.float32)
    scope.new_scope()
    before = scope._version
    if mutate == "setitem":
        scope["w"] = np.ones(2, np.float32)
    elif mutate == "var":
        scope.var("fresh")
    elif mutate == "set":
        scope.find_var("w").get_tensor().set(np.ones(2, np.float32))
    elif mutate == "drop_kids":
        scope.drop_kids()
    else:
        scope.drop()
    assert scope._version > before


def test_child_scope_shadowing_invalidates_owner_resolution():
    main, startup, loss = _mlp(tfluid, seed=29)
    test_prog = main.clone(for_test=True)
    feed = _feed(seed=2)
    parent = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(parent):
        np.random.seed(41)
        exe.run(startup)
    child = parent.new_scope()
    for _ in range(3):
        base = np.asarray(exe.run(test_prog, feed=feed, fetch_list=[loss],
                                  scope=child)[0])
    pname = sorted(n for n in test_prog.persistable_names()
                   if n in parent and ".w_" in n)[0]
    child[pname] = np.zeros_like(np.asarray(parent[pname]))
    shadowed = np.asarray(exe.run(test_prog, feed=feed, fetch_list=[loss],
                                  scope=child)[0])
    assert shadowed.tobytes() != base.tobytes()
    assert np.asarray(parent[pname]).any()


def test_program_version_bump_invalidates_bound_entry():
    prog, sp = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard():
        with tfluid.program_guard(prog, sp):
            x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
            y = tfluid.layers.scale(x, scale=3.0)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    feed = {"x": np.ones((2, 4), np.float32)}
    with tfluid.scope_guard(scope):
        exe.run(sp)
        for _ in range(3):
            out = exe.run(prog, feed=feed, fetch_list=[y])
        np.testing.assert_allclose(np.asarray(out[0]), 3.0 * feed["x"])
        bound = [b for b in _bound(exe) if b.program is prog]
        assert bound and bound[0].version == prog.version
        scale_op = [op for op in prog.global_block().ops
                    if op.type == "scale"][0]
        scale_op.attrs["scale"] = 5.0
        prog._bump()
        out = exe.run(prog, feed=feed, fetch_list=[y])
        np.testing.assert_allclose(np.asarray(out[0]), 5.0 * feed["x"])
        rebound = [b for b in _bound(exe) if b.program is prog]
        assert rebound[0].version == prog.version


def test_persistable_flag_flip_invalidates_state_collection():
    prog, sp = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard():
        with tfluid.program_guard(prog, sp):
            x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
            c = tfluid.layers.fill_constant([2, 2], "float32", 9.0)
            y = tfluid.layers.scale(x, scale=2.0)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    feed = {"x": np.ones((2, 4), np.float32)}
    with tfluid.scope_guard(scope):
        for _ in range(2):
            exe.run(prog, feed=feed, fetch_list=[y])
        assert c.name not in scope
        c.persistable = True  # the setter bumps program.version
        exe.run(prog, feed=feed, fetch_list=[y])
        assert c.name in scope
        np.testing.assert_allclose(np.asarray(scope[c.name]),
                                   np.full((2, 2), 9.0, np.float32))


def test_feed_shape_change_falls_back_and_rebinds():
    main, startup, loss = _mlp(tfluid, seed=67)
    test_prog = main.clone(for_test=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(71)
        exe.run(startup)
        big, small = _feed(batch=8, seed=1), _feed(batch=3, seed=1)
        for _ in range(3):
            exe.run(test_prog, feed=big, fetch_list=[loss])
        out_small = exe.run(test_prog, feed=small, fetch_list=[loss])
        again = exe.run(test_prog, feed=small, fetch_list=[loss])
        exe2 = tfluid.Executor(CPU)
        ref_small = exe2.run(test_prog, feed=small, fetch_list=[loss],
                             use_program_cache=False)
    assert len(_bound(exe)) == 2  # one entry per feed shape
    for out in (out_small, again):
        assert np.asarray(out[0]).tobytes() == np.asarray(ref_small[0]).tobytes()


def test_feed_kind_change_takes_the_slow_path():
    """The plan records each feed's kind: a tensor where a numpy array
    was bound (same shape and values) misses, rebinds, and gives the same
    bits."""
    main, startup, loss = _mlp(tfluid, seed=3)
    test_prog = main.clone(for_test=True)
    feed = _feed(seed=4)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(5)
        exe.run(startup)
        for _ in range(2):
            ref = exe.run(test_prog, feed=feed, fetch_list=[loss])
        (bound,) = _bound(exe)
        as_tensors = {k: torch.from_numpy(v) for k, v in feed.items()}
        for _ in range(2):
            out = exe.run(test_prog, feed=as_tensors, fetch_list=[loss])
        (rebound,) = _bound(exe)
    assert rebound is not bound
    assert np.asarray(out[0]).tobytes() == np.asarray(ref[0]).tobytes()


def test_lod_feed_after_bind_takes_slow_path():
    main, startup, loss = _mlp(tfluid, seed=83)
    test_prog = main.clone(for_test=True)
    feed = _feed(batch=4, seed=4)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(89)
        exe.run(startup)
        for _ in range(3):
            ref = exe.run(test_prog, feed=feed, fetch_list=[loss])
        lod_feed = {"x": LoDArray(feed["x"], np.array([1, 1, 1, 1], np.int32)),
                    "y": feed["y"]}
        out = exe.run(test_prog, feed=lod_feed, fetch_list=[loss])
        assert np.isfinite(float(np.asarray(out[0])))
        again = exe.run(test_prog, feed=feed, fetch_list=[loss])
        assert np.asarray(again[0]).tobytes() == np.asarray(ref[0]).tobytes()


def test_bound_entry_does_not_pin_dead_scopes():
    main, startup, loss = _mlp(tfluid, seed=91)
    exe = tfluid.Executor(CPU)
    feed = _feed(seed=6)
    probes = []
    for _ in range(3):  # a fresh scope a trial
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            np.random.seed(5)
            exe.run(startup)
            for _ in range(3):
                exe.run(main, feed=feed, fetch_list=[loss])
        probes.append(weakref.ref(scope))
        del scope
    gc.collect()
    assert all(p() is None for p in probes), (
        "the executor's bound entries kept dropped scopes alive")


# ---------------------------------------------------------------------------
# fetches
# ---------------------------------------------------------------------------


def test_fetched_values_never_change_after_later_steps():
    """A parameter fetched directly, an ``assign`` of it and the loss come
    back lazily from the bound entry, while the step updates the
    parameter in place.  A lazy fetch held across later steps
    materializes its own step's value, the assign (the parameter before
    the update) equals the previous step's parameter, and a parameter
    read through the scope as numpy never changes."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard():
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
            y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
            pred = tfluid.layers.fc(x, size=1,
                                    param_attr=tfluid.ParamAttr(name="w_fp"))
            loss = tfluid.layers.mean(tfluid.layers.square(pred - y))
            w_snapshot = tfluid.layers.assign(
                tfluid.default_main_program().global_block().var("w_fp"))
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.random_seed = 3
    feed = _feed(width=4, batch=4, seed=8)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(19)
        exe.run(startup)
        fetch = ["w_fp", w_snapshot, loss]
        outs = [exe.run(main, feed=feed, fetch_list=fetch) for _ in range(6)]
        assert _bound(exe), "the fast path never engaged"
        assert all(isinstance(v, LazyFetch) for v in outs[-1])
        assert all(isinstance(v, np.ndarray) for v in outs[0])  # slow path
        w_read = np.asarray(scope.find_var("w_fp").get_tensor())
        w_keep = w_read.copy()
        held = outs[3][2]
        tensors = exe.run(main, feed=feed, fetch_list=fetch,
                          return_numpy=False)
        t_copy = [t.clone() for t in tensors]
        exe.run(main, feed=feed, fetch_list=fetch)
        held_np = np.asarray(held)
        assert np.isfinite(held_np).all()
        snaps = [o[0].tobytes() for o in outs]
        assert len(set(snaps)) == len(snaps)
        for prev, cur in zip(outs, outs[1:]):
            assert np.asarray(cur[1]).tobytes() == prev[0].tobytes()
        for t, c in zip(tensors, t_copy):
            assert torch.equal(t, c)
        assert w_read.tobytes() == w_keep.tobytes()
        assert not np.array_equal(w_read, np.asarray(scope["w_fp"]))


def test_lazy_fetch_materializes_correct_numpy():
    main, startup, loss = _mlp(tfluid, seed=53)
    test_prog = main.clone(for_test=True)
    feed = _feed(seed=17)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(61)
        exe.run(startup)
        expected = np.asarray(exe.run(test_prog, feed=feed, fetch_list=[loss],
                                      use_program_cache=False)[0])
        for _ in range(3):
            out = exe.run(test_prog, feed=feed, fetch_list=[loss])[0]
    assert isinstance(out, LazyFetch)
    assert out.shape == tuple(expected.shape)
    assert out.dtype == expected.dtype
    assert np.asarray(out).tobytes() == expected.tobytes()
    np.testing.assert_allclose(np.ravel(out)[0], np.ravel(expected)[0])
    assert float(out + 0.0) == float(expected)
    assert (out * 2 == expected * 2).all()
    twin = LazyFetch(torch.from_numpy(expected.copy()))
    assert float(np.abs(out - twin).max()) == 0.0   # two lazy operands


def test_lazy_fetch_reports_bfloat16_as_float32_without_copying():
    lazy = LazyFetch(torch.ones((2, 3), dtype=torch.bfloat16))
    assert lazy.shape == (2, 3) and lazy.dtype == np.float32
    assert lazy._np is None  # metadata did not materialize it
    np.testing.assert_array_equal(np.asarray(lazy), np.ones((2, 3)))


def test_use_program_cache_false_never_binds():
    """``use_program_cache=False`` is the op-by-op path: no entry bound,
    nothing captured, numpy fetches, and the default path's bits."""
    main, startup, loss = _mlp(tfluid, seed=2)
    feeds = [_feed(seed=s) for s in range(3)]
    ls, ps, exe, compiles = _run_steps(main, startup, loss, feeds, False)
    lf, pf, _, _ = _run_steps(main, startup, loss, feeds, True)
    assert not exe._bound and compiles == 0
    assert all(isinstance(v, np.ndarray) for v in ls)
    _assert_bitwise(pf, ps)
    assert [a.tobytes() for a in lf] == [b.tobytes() for b in ls]


def test_as_numpy_is_a_copy():
    """A step updates the scope's state in place once captured, so no
    array handed out may share a tensor's memory."""
    for t in (torch.arange(4.0), torch.arange(4.0).to(torch.bfloat16)):
        a = texe.as_numpy(t)
        t.add_(1)
        np.testing.assert_array_equal(a, np.arange(4.0))


# ---------------------------------------------------------------------------
# counters and caps
# ---------------------------------------------------------------------------


def test_bound_cache_cap_evicts_and_counts(monkeypatch):
    monkeypatch.setattr(texe, "_BOUND_CAP", 2)
    main, startup, loss = _mlp(tfluid, seed=4)
    test_prog = main.clone(for_test=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(9)
        exe.run(startup)
        before = texe.cache_eviction_count()[1]
        outs = {}
        for batch in (2, 3, 4, 5, 2, 3):
            outs.setdefault(batch, []).append(np.asarray(exe.run(
                test_prog, feed=_feed(batch=batch), fetch_list=[loss])[0]))
        assert len(exe._bound) <= 2
        assert texe.cache_eviction_count()[1] - before >= 3
    for vals in outs.values():
        assert len({v.tobytes() for v in vals}) == 1


def test_graph_cap_evicts_the_least_recently_used_capture(monkeypatch):
    monkeypatch.setattr(texe, "_GRAPH_CAP", 2)
    main, startup, loss = _mlp(tfluid, seed=14)
    test_prog = main.clone(for_test=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(9)
        exe.run(startup)
        e0 = texe.cache_eviction_count()[0]
        outs = {}
        for batch in (2, 2, 3, 3, 2, 4, 4, 2):
            outs.setdefault(batch, []).append(np.asarray(exe.run(
                test_prog, feed=_feed(batch=batch), fetch_list=[loss])[0]))
        captured = sorted(b.static_feeds["x"].shape[0] for b in _bound(exe)
                          if b.step is not None)
    # batch 4's capture evicted batch 3's (batch 2 was used since); the
    # last run of batch 2 replayed its entry
    assert captured == [2, 4]
    assert texe.cache_eviction_count()[0] - e0 == 1
    for vals in outs.values():
        assert len({v.tobytes() for v in vals}) == 1


def test_a_bound_entry_keeps_no_step_environment_alive():
    """After a run, no step's environment (every intermediate tensor of
    the step) is alive: on the card those of the captured step are blocks
    of the executor's pool, which the next capture must be able to
    reuse."""
    main, startup, loss = _mlp(tfluid, seed=16)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(4)
        exe.run(startup)
        for batch in (4, 4, 4, 6, 6, 6):
            exe.run(main, feed=_feed(batch=batch), fetch_list=[loss])
    gc.collect()
    assert [b.step is not None for b in _bound(exe)].count(True) == 2
    assert not [o for o in gc.get_objects()
                if isinstance(o, texe.LoweringContext)]


def test_dropping_the_executor_frees_its_steps_without_the_collector():
    """A captured entry holds its step, and no reference cycle runs from
    the step back to the entry or the Executor: dropping the Executor
    frees its steps (on the card their graphs and pool) at once, not at
    the next run of the cycle collector."""
    main, startup, loss = _mlp(tfluid, seed=18)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    gc.collect()
    gc.disable()
    try:
        with tfluid.scope_guard(scope):
            np.random.seed(4)
            exe.run(startup)
            for _ in range(3):
                exe.run(main, feed=_feed(), fetch_list=[loss])
        steps = [weakref.ref(b.step) for b in _bound(exe)
                 if b.step is not None]
        del exe
        assert steps and all(r() is None for r in steps)
    finally:
        gc.enable()


@pytest.mark.parametrize("holds_graphs", [True, False])
def test_out_of_memory_in_a_first_run_drops_the_graphs_once(monkeypatch,
                                                             holds_graphs):
    """A new shape's first, op-by-op run that runs out of memory beside the
    executor's captured graphs drops them and runs the step again, with
    the bits of a run that never ran out; without graphs to give back,
    the error stands."""
    main, startup, loss = _mlp(tfluid, seed=15)
    test_prog = main.clone(for_test=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        np.random.seed(3)
        exe.run(startup)
        for _ in range(3 if holds_graphs else 0):
            exe.run(test_prog, feed=_feed(batch=4), fetch_list=[loss])
        assert exe._holds_graphs() is holds_graphs
        want = exe.run(test_prog, feed=_feed(batch=6), fetch_list=[loss],
                       use_program_cache=False)[0]
        real, calls = texe.lower_block, []

        def out_of_memory_once(ctx, block):
            calls.append(block)
            if len(calls) == 1:
                raise torch.cuda.OutOfMemoryError("out of memory (test)")
            return real(ctx, block)

        monkeypatch.setattr(texe, "lower_block", out_of_memory_once)
        e0 = texe.cache_eviction_count()[0]
        if not holds_graphs:
            with pytest.raises(torch.cuda.OutOfMemoryError):
                exe.run(test_prog, feed=_feed(batch=6), fetch_list=[loss])
            return
        got = exe.run(test_prog, feed=_feed(batch=6), fetch_list=[loss])[0]
    assert len(calls) == 2 and not exe._holds_graphs()
    assert texe.cache_eviction_count()[0] - e0 == 1
    assert got.tobytes() == want.tobytes()


def test_feed_host_copy_count_moves_only_for_host_feeds():
    main, startup, loss = _mlp(tfluid, seed=6)
    test_prog = main.clone(for_test=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    feed = _feed()
    as_tensors = {k: torch.from_numpy(v) for k, v in feed.items()}
    with tfluid.scope_guard(scope):
        np.random.seed(1)
        exe.run(startup)
        c0 = texe.feed_host_copy_count()
        for _ in range(3):
            exe.run(test_prog, feed=feed, fetch_list=[loss])
        c1 = texe.feed_host_copy_count()
        for _ in range(3):
            exe.run(test_prog, feed=as_tensors, fetch_list=[loss])
        c2 = texe.feed_host_copy_count()
    assert c1 - c0 == 6  # two numpy feeds a run, slow and bound paths
    assert c2 == c1      # tensors already on the executor's device


class _Records:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_step_records_say_fast_path_and_compile():
    main, startup, loss = _mlp(tfluid, seed=8)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    sink = tobs.add_sink(_Records())
    try:
        with tfluid.scope_guard(scope):
            np.random.seed(2)
            exe.run(startup)
            for _ in range(3):
                exe.run(main, feed=_feed(), fetch_list=[loss])
    finally:
        tobs.remove_sink(sink)
    steps = [r for r in sink.records if r.get("source") == "executor"]
    # the startup (creates state: never bound), then the main program's
    # first run, which binds, then its capture and a replay
    assert [r["fast_path"] for r in steps] == [False, False, True, True]
    assert [r["compile"] for r in steps] == [False, False, True, False]
    assert all(r["type"] == "step" and r["duration_s"] > 0 for r in steps)


def test_jit_step_cache_counts_compiles_and_evicts():
    built = []

    def build(key):
        built.append(key)
        return lambda x: x * key

    cache = JitStepCache(build, cap=2, name="test")
    c0, (_, e0) = texe.compile_count(), texe.cache_eviction_count()
    x = torch.arange(4.0)
    assert torch.equal(cache.get(2)(x), x * 2)
    assert torch.equal(cache.get(2)(x), x * 2)  # a hit: no build
    cache.get(3)
    cache.get(2)           # touch 2: 3 is now the oldest
    cache.get(5)           # evicts 3
    assert cache.keys() == [2, 5] and len(cache) == 2
    assert built == [2, 3, 5]
    assert texe.compile_count() - c0 == 3
    assert texe.cache_eviction_count()[1] - e0 == 1
    cache.get(3)           # rebuilt: a compile again
    assert built == [2, 3, 5, 3] and texe.compile_count() - c0 == 4


@pytest.mark.parametrize("second", ["scalar", "shape", "dtype", "count"])
def test_graphed_call_refuses_what_its_first_call_did_not_fix(second):
    """A captured graph replays its first call's shapes and non-tensor
    values, so a call with others raises (on the CPU too) instead of
    broadcasting into the static buffers or reusing the old scalar."""
    fn = JitStepCache(lambda key: (lambda x, s: x * s)).get("k")
    x = torch.ones(4)
    assert torch.equal(fn(x, 0.5), x * 0.5)
    assert torch.equal(fn(torch.arange(4.0), 0.5), torch.arange(4.0) * 0.5)
    args = {"scalar": (x, 0.9), "shape": (torch.ones(1), 0.5),
            "dtype": (torch.ones(4, dtype=torch.float64), 0.5),
            "count": (x,)}[second]
    with pytest.raises(ValueError, match="first call"):
        fn(*args)


def test_jit_step_cache_entry_is_the_callable_on_the_cpu():
    cache = JitStepCache(lambda key: (lambda a, b: (a + b, a * b)))
    fn = cache.get("k")
    a, b = torch.ones(3), torch.full((3,), 2.0)
    for _ in range(3):  # no warm-up, capture or copies on the CPU
        s, p = fn(a, b)
        assert torch.equal(s, a + b) and torch.equal(p, a * b)
    assert fn._graph is None


# ---------------------------------------------------------------------------
# nan_guard, against the JAX package on the same Program and parameters
# ---------------------------------------------------------------------------


def _guard_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard():
        with fl.program_guard(main, startup):
            x = fl.layers.data(name="x", shape=[4], dtype="float32")
            loss = fl.layers.mean(fl.layers.fc(x, size=1))
            fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


GOOD = {"x": np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4)}
BAD = {"x": np.full((2, 4), np.nan, np.float32)}


def test_nan_guard_matches_the_jax_package():
    """The same Program (the JAX package's JSON), parameters and feeds,
    each guarded step run twice (the slow path, then the bound entry):
    the same verdicts; a NaN step leaves every persistable bitwise
    unchanged; the finite steps' parameters within PARAM_RTOL of the JAX
    package's; an unguarded run has no verdict."""
    jmain, jstart, jloss = _guard_program(jfluid)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        np.random.seed(29)
        jexe.run(jstart)
        state = {n: np.asarray(jscope[n]) for n in jmain.persistable_names()
                 if n in jscope}
    main = tfluid.Program.parse_from_string(jmain.to_string())
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    tfluid.load_numpy_state(main, state, scope=scope, device="cpu")
    sequence = [GOOD, GOOD, BAD, BAD, GOOD]
    for feed in sequence:
        with jfluid.scope_guard(jscope):
            jout = jexe.run(jmain, feed=feed, fetch_list=[jloss],
                            nan_guard=True)
            jok = jexe.last_step_ok()
            jparams = {n: np.array(jscope[n]) for n in state}
        before = _params(main, scope)
        out = exe.run(main, feed=feed, fetch_list=[jloss.name], scope=scope,
                      nan_guard=True)
        ok = exe.last_step_ok()
        assert len(out) == 1  # the verdict never leaks into the fetches
        assert ok is jok is bool(np.isfinite(feed["x"]).all())
        after = _params(main, scope)
        if not ok:
            _assert_bitwise(after, before)
        for n, v in jparams.items():
            np.testing.assert_allclose(after[n], v, rtol=PARAM_RTOL,
                                       atol=PARAM_RTOL, err_msg=n)
    assert _bound(exe)
    exe.run(main, feed=GOOD, fetch_list=[jloss.name], scope=scope)
    with jfluid.scope_guard(jscope):
        jexe.run(jmain, feed=GOOD, fetch_list=[jloss])
    assert exe.last_step_ok() is None and jexe.last_step_ok() is None


def test_finite_guarded_steps_equal_unguarded_bitwise():
    main, startup, loss = _mlp(tfluid, seed=33)
    feeds = [_feed(seed=s) for s in range(4)]
    results = []
    for guard in (False, True):
        scope = tfluid.Scope()
        exe = tfluid.Executor(CPU)
        with tfluid.scope_guard(scope):
            np.random.seed(4)
            exe.run(startup)
            losses = [np.array(exe.run(main, feed=f, fetch_list=[loss],
                                       nan_guard=guard)[0]) for f in feeds]
            results.append((losses, _params(main, scope),
                            exe.last_step_ok()))
    (l0, p0, ok0), (l1, p1, ok1) = results
    assert ok0 is None and ok1 is True
    _assert_bitwise(p0, p1)
    assert [a.tobytes() for a in l0] == [b.tobytes() for b in l1]


def test_nan_guard_has_no_verdict_for_a_stateless_step():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard():
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
            out = tfluid.layers.fc(x, size=1)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):  # the slow path, then the bound entry
            res = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                          fetch_list=[out], nan_guard=True)
            assert len(res) == 1
            assert exe.last_step_ok() is None


def test_nan_guard_skips_the_whole_update_of_a_transformer_step():
    """A NaN parameter set through the scope (which rebinds the entry):
    every guarded step's verdict is False and every persistable, Adam's
    moments and counters included, bitwise unchanged; with the parameter
    restored the next step is True."""
    with tfluid.unique_name.guard():
        tm = TT.get_model(dropout=0.1, **TINY)
    tm["startup"].random_seed = 3
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    feeds = _transformer_feeds(5, seed=2)
    with tfluid.scope_guard(scope):
        exe.run(tm["startup"])
        exe.run(tm["main"], feed=feeds[0], fetch_list=[tm["loss"]],
                nan_guard=True)
        assert exe.last_step_ok() is True
        pname = tm["main"].global_block().all_parameters()[0].name
        saved = scope[pname].clone()
        bad = saved.clone()
        bad.view(-1)[0] = float("nan")
        scope[pname] = bad
        for f in feeds[1:3]:
            before = {n: np.array(scope[n]).tobytes()
                      for n in tm["main"].persistable_names() if n in scope}
            exe.run(tm["main"], feed=f, fetch_list=[tm["loss"]],
                    nan_guard=True)
            assert exe.last_step_ok() is False
            after = {n: np.array(scope[n]).tobytes() for n in before}
            assert after == before
        scope[pname] = saved
        exe.run(tm["main"], feed=feeds[3], fetch_list=[tm["loss"]],
                nan_guard=True)
        assert exe.last_step_ok() is True


# ---------------------------------------------------------------------------
# which Programs the card may capture
# ---------------------------------------------------------------------------


def test_a_program_that_waits_on_the_host_is_never_bound():
    """Each run of a Program with a ``reads_host`` rule takes the op-by-op
    path, counted under the op; nothing binds or captures."""
    prog, sp = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard():
        with tfluid.program_guard(prog, sp):
            x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
            c = tfluid.layers.assign(np.arange(3, dtype=np.float32))
            y = tfluid.layers.elementwise_add(x, c)
    op = next(o.type for o in prog.global_block().ops
              if treg.reads_host(o.type))
    refused = tobs.counter("executor.graph_refused", {"op": op})
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    feed = {"x": np.ones((2, 3), np.float32)}
    r0, c0 = refused.value, texe.compile_count()
    with tfluid.scope_guard(scope):
        exe.run(sp)
        outs = [exe.run(prog, feed=feed, fetch_list=[y])[0]
                for _ in range(3)]
    assert refused.value - r0 == 3 and texe.compile_count() == c0
    assert not [b for b in _bound(exe) if b.program is prog]
    for o in outs:
        np.testing.assert_array_equal(o, np.tile(1.0 + np.arange(3.0), (2, 1)))


def test_graph_refusal_names_the_op_that_waits_on_the_host():
    with tfluid.unique_name.guard():
        tm = TT.get_model(dropout=0.1, **TINY)
    with tfluid.unique_name.guard():
        inf = TT.get_inference_model(
            beam_size=2, max_out_len=4, seq_len=16, src_vocab_size=60,
            trg_vocab_size=60, max_length=16, n_layer=1, n_head=2,
            d_model=32, d_inner=64)
    assert texe._graph_refusal(tm["main"], {}, [tm["loss"].name]) is None
    assert texe._graph_refusal(tm["test"], {}, []) is None
    assert texe._graph_refusal(inf["infer"], {}, []) == "while"
    env = {"ids": torch.zeros(2), "ids@LENGTHS": torch.ones(2)}
    assert texe._graph_refusal(tm["main"], env, ["ids"]) == "lod_fetch"


# the scan: a rule (and each function of its module it calls) waits on the
# host if it reads a device value back, or copies host data to the card
_READBACK = {"item", "tolist", "cpu", "numpy"}
_CASTS = {"bool", "int", "float"}
_METADATA_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_METADATA_CALLS = {"dim", "numel", "size", "element_size", "stride",
                   "is_floating_point", "is_contiguous", "data_ptr"}
_CTX_READS = {"get", "get_input", "get_inputs", "get_lengths",
              "get_sub_lengths"}
# torch calls that give no tensor
_TORCH_HOST = {"iinfo", "finfo", "device", "Size", "get_default_dtype"}


def _tensor_names(fn_node):
    """Names the function binds to tensors: assigned from an expression
    that reads the environment, calls torch, or uses such a name."""
    names = set()
    assigns = [n for n in ast.walk(fn_node)
               if isinstance(n, (ast.Assign, ast.AugAssign, ast.For,
                                 ast.comprehension))]
    for _ in range(3):
        for node in assigns:
            value = node.iter if isinstance(node, (ast.For, ast.comprehension)) \
                else node.value
            targets = ([node.target] if not isinstance(node, ast.Assign)
                       else node.targets)
            if _reads_tensor(value, names):
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
    return names


def _reads_tensor(expr, names):
    """Whether ``expr`` uses a tensor's values (metadata aside): it reads
    the environment (``ctx.get*``, ``ctx.env``), calls torch for a
    tensor, or uses a name bound to one other than for its metadata."""
    parents = {}
    for node in ast.walk(expr):
        for kid in ast.iter_child_nodes(node):
            parents[kid] = node
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            base = node.value.id
            if base == "ctx" and (node.attr in _CTX_READS
                                  or node.attr == "env"):
                return True
            if (base == "torch" and isinstance(parents.get(node), ast.Call)
                    and parents[node].func is node
                    and node.attr not in _TORCH_HOST):
                return True
        if isinstance(node, ast.Name) and node.id in names:
            up = parents.get(node)
            if isinstance(up, ast.Attribute) and (
                    up.attr in _METADATA_ATTRS or up.attr in _METADATA_CALLS):
                continue
            return True
    return False


def _host_waits(fn_node):
    """Lines of ``fn_node`` that wait on the host."""
    names = _tensor_names(fn_node)
    found = []
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        text = ast.unparse(node)
        if isinstance(f, ast.Attribute) and f.attr in _READBACK:
            found.append(text)
        elif isinstance(f, ast.Attribute) and (
                f.attr == "new_tensor" or ast.unparse(f) in (
                    "torch.tensor", "torch.as_tensor")):
            found.append(text)
        elif (isinstance(f, ast.Name) and f.id in _CASTS and node.args
              and _reads_tensor(node.args[0], names)):
            found.append(text)
    return found


def _rule_waits(fn, seen=None):
    """What ``fn`` and the functions of its module it calls do on the
    host."""
    seen = set() if seen is None else seen
    if fn in seen:
        return []
    seen.add(fn)
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    node = tree.body[0]
    found = _host_waits(node)
    module = sys.modules[fn.__module__]
    for call in ast.walk(node):
        if isinstance(call, ast.Name):
            callee = getattr(module, call.id, None)
            if (inspect.isfunction(callee)
                    and callee.__module__ == fn.__module__):
                found += _rule_waits(callee, seen)
    return found


def test_reads_host_mark_is_complete():
    """Every rule whose source reads a device value back (``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``bool``/``int``/``float`` of
    a tensor) or copies host data to the card (``torch.tensor``,
    ``torch.as_tensor``, ``new_tensor``) is marked ``reads_host``, and
    every mark has such a line: an unmarked rule would reach a capture
    and fail it, a stale mark would keep a Program off the graph."""
    modules = {fn.__module__ for fn in treg.RULES.values()}
    assert all(m.startswith(("paddle_tpu_torch.ops.",
                             "paddle_tpu_torch.layers.")) for m in modules)
    waits = {op: _rule_waits(fn) for op, fn in treg.RULES.items()}
    flagged = {op for op, lines in waits.items() if lines}
    assert flagged == treg.READS_HOST, {
        "unmarked": {op: waits[op] for op in flagged - treg.READS_HOST},
        "stale": sorted(treg.READS_HOST - flagged)}


@pytest.mark.parametrize("src,waits", [
    ("def r(ctx, op):\n    x = ctx.get_input(op, 'X')\n"
     "    if bool(x.sum() > 0):\n        pass\n", True),
    ("def r(ctx, op):\n    n = ctx.get(op.inputs['N'][0])\n"
     "    k = int(n)\n", True),
    ("def r(ctx, op):\n    x = ctx.get_input(op, 'X')\n"
     "    v = x.max().item()\n", True),
    ("def r(ctx, op):\n    x = ctx.get_input(op, 'X')\n"
     "    t = torch.tensor([x.shape[0]], device=x.device)\n", True),
    ("def r(ctx, op):\n    x = ctx.get_input(op, 'X')\n"
     "    k = int(op.attrs['k'])\n    n = int(x.shape[0])\n"
     "    d = int(x.dim())\n    s = [int(s) for s in op.attrs['shape']]\n",
     False),
])
def test_reads_host_scan_tells_host_reads_apart(src, waits):
    assert bool(_host_waits(ast.parse(src).body[0])) is waits


def _host_constant_program(kind):
    """A one-op Program whose rule makes constants from attrs, and its
    feed as host tensors (a numpy feed is lifted into a tensor)."""
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = L.data(name="x", shape=[5], dtype="float32")
        if kind == "nce_custom_negatives":
            y = L.data(name="y", shape=[1], dtype="int64")
            out = L.nce(x, y, num_total_classes=8, num_neg_samples=3)
            (op,) = [o for o in main.global_block().ops if o.type == "nce"]
            op.attrs["custom_neg_classes"] = [1, 4, 6]
            feed = {"x": torch.rand(4, 5),
                    "y": torch.tensor([[1], [2], [3], [0]])}
        elif kind == "lod_reset_target_lod":
            out = L.lod_reset(x, target_lod=[0, 2, 4])
            feed = {"x": torch.rand(4, 5)}
        else:
            img = L.data(name="img", shape=[3, 16, 16], dtype="float32")
            fm = L.data(name="fm", shape=[2, 4, 4], dtype="float32")
            box, _ = L.prior_box(fm, img, min_sizes=[4.0], max_sizes=[8.0],
                                 aspect_ratios=[2.0], flip=True)
            y = L.data(name="y", shape=[4], dtype="float32")
            out = L.box_coder(L.reshape(box, [-1, 4]), None, y,
                              box_normalized=False)
            feed = {"x": torch.rand(4, 5), "y": torch.rand(4, 4),
                    "img": torch.zeros(1, 3, 16, 16),
                    "fm": torch.zeros(1, 2, 4, 4)}
    return main, startup, out, feed


@pytest.mark.parametrize("kind", ["nce_custom_negatives",
                                  "lod_reset_target_lod", "prior_box_coder"])
def test_rules_make_constants_on_the_device_f22(kind):
    """F-22: a constant a rule builds from its attrs is filled on the
    device, never lifted from a host scalar and copied (``out[i] = v``),
    which a CUDA graph capture refuses: a dense-fed Program holding
    ``nce`` with ``custom_neg_classes`` or ``lod_reset`` with a
    ``target_lod`` failed its capture on the card.  Fed host tensors,
    the step lifts nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Lifts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.count += func is torch.ops.aten.lift_fresh.default
            return func(*args, **(kwargs or {}))

    main, startup, out, feed = _host_constant_program(kind)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    with Lifts() as lifts:
        (got,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope,
                         use_program_cache=False)
    assert lifts.count == 0 and np.isfinite(np.asarray(got)).all()
