"""The port's ``layers.Pipeline`` and its ``pipeline`` op rule against the
JAX package's, on the CPU.

The single-device cases of ``tests/unittests/test_pipeline_pp.py``,
``test_pipeline_parallel.py`` and ``test_pipeline_interactions.py``:
both packages build the same Programs (the same ``to_string()`` JSON),
the port's seeded startup state is copied into both, and both run the
same seeded feeds, each on the JAX package's sequential microbatch
path (its single-device branch) and the port's.  Sizes: S 4 stages,
M 8 microbatches, width D 16, batch 32 (the reference's), and S 4, M 4,
D 8, batch 16 for the interactions.  Limits:
- forward losses within LOSS_RTOL relative, gradients within GRAD_TOL
  of each gradient's largest magnitude;
- three SGD steps: each loss within LOSS_RTOL, the parameters after
  them within STATE_TOL of each one's largest magnitude;
- port against port (recompute, a bound step against its op-by-op
  steps, ``Trainer(parallel=True)`` against ``Trainer()``): bitwise.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import pipeline as JP
from paddle_tpu_torch.parallel import pipeline as TP

S, M, D = 4, 8, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5    # of each gradient's largest magnitude
STATE_TOL = 1e-5   # of each parameter's largest magnitude


def _data(batch=32, seed=0, width=D):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, width).astype("float32"),
            "y": rng.randn(batch, width).astype("float32")}


def _program(fl, stages=S, microbatches=M, width=D, repeats=1, minimize=True,
             recompute=False, clip=False, decay=False, dropout=0.0, lr=0.1):
    """The reference tests' pipeline: one ``fc(tanh)`` a stage (with an
    L2-decayed weight, a dropout after it), a mean squared error, SGD
    (with a global-norm clip); without ``minimize``, ``calc_gradient`` of
    the loss for every parameter.  Returns (main, startup, fetch names)."""
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[width], dtype="float32")
        y = L.data(name="y", shape=[width], dtype="float32")
        pipe = L.Pipeline(num_stages=stages, num_microbatches=microbatches,
                          circular_repeats=repeats)
        with pipe.stage():
            h = pipe.stage_input(x)
            pa = (fl.ParamAttr(regularizer=fl.regularizer.L2Decay(1e-3))
                  if decay else None)
            o = L.fc(h, size=width, act="tanh", param_attr=pa)
            if dropout:
                o = L.dropout(o, dropout_prob=dropout)
            pipe.stage_output(o)
        loss = L.mean(L.square_error_cost(input=pipe(), label=y))
        fetch = [loss.name]
        if minimize:
            if clip:
                fl.clip.set_gradient_clip(
                    fl.clip.GradientClipByGlobalNorm(clip_norm=0.1))
            fl.optimizer.SGD(learning_rate=lr).minimize(loss)
        else:
            params = main.global_block().all_parameters()
            fetch += [g.name for g in fl.backward.calc_gradient(loss, params)]
    if recompute:
        main.enable_recompute(segments=2)
    return main, startup, fetch


def _both(build, seed=31):
    """``build(fluid)`` by both packages (asserted the same JSON), the
    port's startup run with ``seed``; returns (jax main, jax scope, port
    main, port scope, fetch names)."""
    jm, js, fetch = build(jfluid)
    tm, ts, tfetch = build(tfluid)
    assert jm.to_string() == tm.to_string() and fetch == tfetch
    assert js.to_string() == ts.to_string()
    ts.random_seed = seed
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(ts, scope=tscope)
    jscope = jfluid.Scope()
    for n in tm.persistable_names():
        if n in tscope and tscope[n] is not None:
            jscope[n] = np.array(tscope[n])
    return jm, jscope, tm, tscope, fetch


def _params(prog, scope):
    return {p.name: np.array(scope[p.name])
            for p in prog.global_block().all_parameters()}


def _within(got, want, tol):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) / scale <= tol


def test_pipeline_params_are_stacked_and_survive_a_round_trip():
    main, startup, fetch = _program(tfluid)
    params = main.global_block().all_parameters()
    assert sorted(tuple(p.shape) for p in params) == [(S, D), (S, D, D)]
    assert all(getattr(p, "pp_stacked", False) for p in params)
    clone = tfluid.Program.parse_from_string(main.to_string())
    assert sorted(v.name for v in clone.global_block().vars.values()
                  if getattr(v, "pp_stacked", False)) == sorted(
                      p.name for p in params)
    test_clone = main.clone(for_test=True)
    assert any(op.type == "pipeline" for op in test_clone.global_block().ops)
    assert all(getattr(test_clone.global_block().vars[p.name], "pp_stacked",
                       False) for p in params)
    # the round-tripped Program runs, with the same bits
    feed = _data(seed=6)
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = []
    for prog in (main, clone):
        scope = tfluid.Scope()
        startup.random_seed = 4
        exe.run(startup, scope=scope)
        (lv,) = exe.run(prog, feed=feed, fetch_list=fetch[:1], scope=scope)
        losses.append(np.asarray(lv))
    assert losses[0].tobytes() == losses[1].tobytes()


@pytest.mark.parametrize("repeats", [1, 2])
def test_forward_and_gradients_match_jax(repeats):
    """Loss and ``calc_gradient`` of every stacked parameter against the
    JAX package's sequential path: S 4, M 8, D 16, and the circular
    layout with R 2 (virtual stage v reads row circular_stage_index)."""
    jm, jscope, tm, tscope, fetch = _both(
        lambda fl: _program(fl, repeats=repeats, minimize=False))
    feed = _data(seed=2)
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(jm, feed=feed,
                                                      fetch_list=fetch)
    got = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=tscope)
    np.testing.assert_allclose(np.ravel(got[0]), np.ravel(want[0]),
                               rtol=LOSS_RTOL)
    for w, g in zip(want[1:], got[1:]):
        g = np.asarray(g)
        assert g.shape == np.asarray(w).shape and g.shape[0] == S
        assert _within(g, np.asarray(w), GRAD_TOL)
        # every stage's slice receives a gradient
        assert (np.abs(g).reshape(S, -1).sum(axis=1) > 0).all()


@pytest.mark.parametrize("stages,repeats", [(4, 2), (6, 2), (6, 3), (4, 1)])
def test_circular_stage_index_matches_jax(stages, repeats):
    n_dev = stages // repeats
    rows = [TP.circular_stage_index(v, n_dev, repeats) for v in range(stages)]
    assert rows == [JP.circular_stage_index(v, n_dev, repeats)
                    for v in range(stages)]
    assert sorted(rows) == list(range(stages))


INTERACTIONS = {
    "plain": {},
    "recompute": {"recompute": True},
    "global_norm_clip": {"clip": True},
    "weight_decay": {"decay": True},
}


@pytest.mark.parametrize("case", list(INTERACTIONS))
def test_training_steps_match_jax(case):
    """Three SGD steps at S 4, M 4, D 8 against the JAX package, alone and
    composed with recompute, a global-norm clip and weight decay."""
    kw = INTERACTIONS[case]
    build = lambda fl: _program(fl, microbatches=4, width=8, **kw)  # noqa: E731
    jm, jscope, tm, tscope, fetch = _both(build, seed=43)
    feed = _data(batch=16, seed=1, width=8)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for _ in range(3):
        with jfluid.scope_guard(jscope):
            (want,) = jexe.run(jm, feed=feed, fetch_list=fetch)
        (got,) = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(np.ravel(got), np.ravel(want),
                                   rtol=LOSS_RTOL)
    want, got = _params(jm, jscope), _params(tm, tscope)
    for n in want:
        assert _within(got[n], want[n], STATE_TOL), n


def _steps(prog, startup, fetch, feed, n, cache, seed=5, **run):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    startup.random_seed = seed
    exe.run(startup, scope=scope)
    out = [[np.asarray(v) for v in exe.run(prog, feed=feed, fetch_list=fetch,
                                           scope=scope,
                                           use_program_cache=cache, **run)]
           for _ in range(n)]
    return out, _params(prog, scope), exe


def test_recompute_keeps_the_bits_of_the_pipeline():
    feed = _data(batch=16, seed=1, width=8)
    runs = []
    for recompute in (False, True):
        main, startup, fetch = _program(tfluid, microbatches=4, width=8,
                                        recompute=recompute)
        runs.append(_steps(main, startup, fetch, feed, 3, cache=False)[:2])
    (l0, p0), (l1, p1) = runs
    assert [v[0].tobytes() for v in l0] == [v[0].tobytes() for v in l1]
    assert all(p0[n].tobytes() == p1[n].tobytes() for n in p0)


def test_bound_step_with_dropout_is_bitwise_its_op_by_op_steps():
    """Dropout inside the stage body draws once a stage and microbatch; the
    bound step (captured after its first run) gives each repeated draw a
    generator of its own, seeded as the first, so its steps keep the bits
    of the op-by-op steps."""
    main, startup, fetch = _program(tfluid, dropout=0.3)
    feed = _data(seed=7)
    eager, pe, _ = _steps(main, startup, fetch, feed, 4, cache=False)
    bound, pb, exe = _steps(main, startup, fetch, feed, 4, cache=True)
    assert len(exe._bound) == 1
    assert all(b.step is not None for b in exe._bound.values())
    assert [v[0].tobytes() for v in eager] == [v[0].tobytes() for v in bound]
    assert all(pe[n].tobytes() == pb[n].tobytes() for n in pe)
    assert eager[0][0].tobytes() != eager[1][0].tobytes()


def _train_func():
    L = tfluid.layers
    x = L.data(name="x", shape=[D], dtype="float32")
    y = L.data(name="y", shape=[D], dtype="float32")
    pipe = L.Pipeline(num_stages=S, num_microbatches=M)
    with pipe.stage():
        h = pipe.stage_input(x)
        o = L.fc(h, size=D, act="tanh")
        pipe.stage_output(o)
    return L.mean(L.square_error_cost(input=pipe(), label=y))


def test_pipeline_under_a_parallel_trainer():
    """``Trainer(parallel=True)`` (a one-device mesh) drives the pipeline
    with the bits of ``Trainer()``, its bound steps included."""
    feed = _data(seed=3)
    batch = list(zip(feed["x"], feed["y"]))

    def run(parallel):
        np.random.seed(123)  # the startup's seed: one start state for both
        t = tfluid.Trainer(_train_func,
                           lambda: tfluid.optimizer.SGD(learning_rate=0.05),
                           place=tfluid.CPUPlace(), parallel=parallel)
        losses = []

        def handler(e):
            if isinstance(e, tfluid.EndStepEvent):
                losses.append(np.asarray(e.metrics[0]).tobytes())

        t.train(num_epochs=1, event_handler=handler,
                reader=lambda: iter([batch] * 4), feed_order=["x", "y"])
        return losses, t.exe._mesh

    seq, no_mesh = run(False)
    par, mesh = run(True)
    assert no_mesh is None and mesh.shape == {"dp": 1}
    assert len(seq) == 4 and par == seq
    assert len(set(seq)) > 1


def test_a_stage_that_changes_the_shape_raises():
    L = tfluid.layers
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        x = L.data(name="x", shape=[D], dtype="float32")
        pipe = L.Pipeline(num_stages=2)
        with pytest.raises(ValueError, match="preserve the activation shape"):
            with pipe.stage():
                h = pipe.stage_input(x)
                pipe.stage_output(L.fc(h, size=D // 2))


def test_a_batch_that_the_microbatches_do_not_divide_raises():
    main, startup, fetch = _program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="not divisible by num_microbatches"):
        exe.run(main, feed=_data(batch=12), fetch_list=fetch, scope=scope)


@pytest.mark.parametrize("kw,match", [
    (dict(num_stages=0), "num_stages"),
    (dict(num_stages=4, circular_repeats=3), "circular_repeats"),
    (dict(num_stages=4, num_microbatches=3, circular_repeats=2),
     "num_microbatches"),
])
def test_pipeline_arguments_are_checked(kw, match):
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        with pytest.raises(ValueError, match=match):
            tfluid.layers.Pipeline(**kw)


TF = dict(batch_size=4, seq_len=8, src_vocab_size=32, trg_vocab_size=32,
          max_length=8, n_layer=2, n_head=2, d_model=32, d_inner=64,
          dropout=0.0, pipeline_stages=2, pipeline_microbatches=2)


def test_pipelined_transformer_matches_jax():
    """``models.transformer.get_model(pipeline_stages=2)`` at 2 layers,
    d_model 32: both stacks pipelined (the pad biases and the encoder's
    output as side inputs), the same Program as the JAX package's, and
    three Adam steps within LOSS_RTOL of its losses."""
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch.models import transformer as TT

    with jfluid.unique_name.guard():
        jm = JT.get_model(**TF)
    with tfluid.unique_name.guard():
        tm = TT.get_model(**TF)
    assert jm["main"].to_string() == tm["main"].to_string()
    assert [op.type for op in tm["main"].global_block().ops].count(
        "pipeline") == 2
    stacked = [p for p in tm["main"].global_block().all_parameters()
               if getattr(p, "pp_stacked", False)]
    assert len(stacked) >= 6 and all(p.shape[0] == 2 for p in stacked)
    tm["startup"].random_seed = 5
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tm["startup"], scope=tscope)
    jscope = jfluid.Scope()
    for n in tm["main"].persistable_names():
        if n in tscope and tscope[n] is not None:
            jscope[n] = np.array(tscope[n])
    rng = np.random.RandomState(8)
    feeds = {n: rng.randint(1, 32, size=(4, 8)).astype("int64")
             for n in tm["feeds"]}
    feeds["src_word"][0, 5:] = TT.PAD_IDX  # a padded source row
    jexe = jfluid.Executor(jfluid.CPUPlace())
    got, want = [], []
    for _ in range(3):
        with jfluid.scope_guard(jscope):
            (w,) = jexe.run(jm["main"], feed=feeds, fetch_list=[jm["loss"]])
        (g,) = texe.run(tm["main"], feed=feeds, fetch_list=[tm["loss"]],
                        scope=tscope)
        want.append(float(np.ravel(w)[0]))
        got.append(float(np.ravel(g)[0]))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("kw,match", [
    (dict(use_flash=True), "use_flash"),
    (dict(n_layer=3), "pipeline_stages"),
])
def test_pipelined_transformer_rejects_what_the_reference_rejects(kw, match):
    from paddle_tpu_torch.models import transformer as TT

    with tfluid.unique_name.guard():
        with pytest.raises(ValueError, match=match):
            TT.get_model(**dict(TF, **kw))
