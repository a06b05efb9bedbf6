"""Learning-rate schedules, gradient clips and weight decay in the port
against the JAX package (ROADMAP §C, F-17): each of these public APIs
builds ops (``floor``, ``exp``, ``ceil``, ``elementwise_max``,
``piecewise_decay``, ``sqrt``, ``sign``, ``clip``, ``clip_by_norm``,
``sum``) that the port had no rule for, so a Program using one raised on
its first run.

Each case builds one Program with each package: one ``fc`` (4 -> 3) on a
seeded numpy batch, the mean squared error, SGD, and the API under test.
The JAX startup's state is copied into the port (``load_numpy_state``),
and both run 6 steps, through a ``piecewise_decay`` boundary (steps 2
and 4) and a ``staircase`` step (decay_steps 2).  Each step's loss and
learning rate, and every persistable after it, must match to 1e-5
relative (of each tensor's largest magnitude: the packages sum in
different orders).

Then the port's fast path: the same Program run 6 steps bound (the
first eager, then the captured step) against 6 steps op by op, from one
state, must give the same bits, with the same number of bound entries
and captures as the Program without the schedule, clip or decay: no op
these APIs add keeps a step off the graph.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texe

RTOL = 1e-5
STEPS = 6


def _lr(fl, case):
    L = fl.layers
    return {
        "exponential_decay_staircase": lambda: L.exponential_decay(
            0.1, 2, 0.5, staircase=True),
        "natural_exp_decay_staircase": lambda: L.natural_exp_decay(
            0.1, 2, 0.5, staircase=True),
        "inverse_time_decay_staircase": lambda: L.inverse_time_decay(
            0.1, 2, 0.5, staircase=True),
        "polynomial_decay_cycle": lambda: L.polynomial_decay(
            0.1, 2, end_learning_rate=0.01, power=2.0, cycle=True),
        "piecewise_decay": lambda: L.piecewise_decay([2, 4], [0.1, 0.05, 0.01]),
    }.get(case, lambda: 0.1)()


CLIPS = {
    "clip_by_value": lambda fl: fl.clip.GradientClipByValue(0.05, -0.05),
    "clip_by_norm": lambda fl: fl.clip.GradientClipByNorm(0.1),
    "clip_by_global_norm": lambda fl: fl.clip.GradientClipByGlobalNorm(0.1),
}

CASES = ["exponential_decay_staircase", "natural_exp_decay_staircase",
         "inverse_time_decay_staircase", "polynomial_decay_cycle",
         "piecewise_decay", "append_LARS", "l1_decay"] + list(CLIPS)


def _build(fl, case):
    """The Program of ``case``: (main, startup, fetch list)."""
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        y = fl.layers.data(name="y", shape=[3], dtype="float32")
        pred = fl.layers.fc(x, size=3)
        loss = fl.layers.mean(fl.layers.square(pred - y))
        lr = _lr(fl, case)
        if case in CLIPS:
            fl.clip.set_gradient_clip(CLIPS[case](fl))
        reg = fl.regularizer.L1Decay(0.01) if case == "l1_decay" else None
        _, params_grads = fl.optimizer.SGD(
            learning_rate=lr, regularization=reg).minimize(loss)
        fetch = [loss] + ([lr] if not isinstance(lr, float) else [])
        if case == "append_LARS":
            fetch += fl.layers.append_LARS(params_grads, 0.1, 0.01)
    main.random_seed = 5
    return main, startup, fetch


def _feed(step):
    rng = np.random.RandomState(100 + step)
    return {"x": rng.randn(8, 4).astype("float32") * 3,
            "y": rng.randn(8, 3).astype("float32")}


def _state(main, scope):
    return {n: np.array(scope[n]) for n in sorted(main.persistable_names())
            if n in scope}


def _close(got, want, what):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _jax_start(case):
    jm, js, jf = _build(jfluid, case)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    return jm, jf, jexe, jscope


@pytest.mark.parametrize("case", CASES)
def test_matches_jax_for_six_steps(case):
    jm, jf, jexe, jscope = _jax_start(case)
    tm, _, tf = _build(tfluid, case)
    assert jm.to_string() == tm.to_string()
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tm, _state(jm, jscope), scope=tscope, device="cpu")
    texec = tfluid.Executor(tfluid.CPUPlace())
    lrs = []
    for step in range(STEPS):
        with jfluid.scope_guard(jscope):
            want = jexe.run(jm, feed=_feed(step), fetch_list=jf)
        got = texec.run(tm, feed=_feed(step), fetch_list=tf, scope=tscope)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(np.asarray(g), np.asarray(w), "fetch %d, step %d" % (i, step))
        jstate, tstate = _state(jm, jscope), _state(tm, tscope)
        assert set(jstate) == set(tstate)
        for n in jstate:
            _close(tstate[n], jstate[n], "%s, step %d" % (n, step))
        if len(got) > 1:
            lrs.append(float(np.asarray(got[1]).reshape(-1)[0]))
    if case == "piecewise_decay":
        assert lrs == [np.float32(v) for v in (0.1, 0.1, 0.05, 0.05, 0.01, 0.01)]
    if case == "exponential_decay_staircase":
        assert lrs[0] == lrs[1] != lrs[2] == lrs[3] != lrs[4]


def _port_steps(case, state, use_program_cache):
    main, _, fetch = _build(tfluid, case)
    scope = tfluid.Scope()
    tfluid.load_numpy_state(main, state, scope=scope, device="cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    before = texe.compile_count()
    outs = [[np.asarray(v) for v in exe.run(
        main, feed=_feed(step), fetch_list=fetch, scope=scope,
        use_program_cache=use_program_cache)] for step in range(STEPS)]
    return outs, _state(main, scope), len(exe._bound), texe.compile_count() - before


@pytest.mark.parametrize("case", CASES)
def test_fast_path_binds_and_replays_bitwise(case):
    jm, _, _, jscope = _jax_start(case)
    state = _state(jm, jscope)
    fast, fstate, bound, compiles = _port_steps(case, state, True)
    slow, sstate, _, slow_compiles = _port_steps(case, state, False)
    pm, _, _, pscope = _jax_start("plain")
    plain = _port_steps("plain", _state(pm, pscope), True)
    assert (bound, compiles) == (plain[2], plain[3]) == (1, 1)
    assert slow_compiles == 0
    for f, s in zip(fast, slow):
        for a, b in zip(f, s):
            assert a.tobytes() == b.tobytes()
    assert set(fstate) == set(sstate)
    for n in fstate:
        assert fstate[n].tobytes() == sstate[n].tobytes(), n
