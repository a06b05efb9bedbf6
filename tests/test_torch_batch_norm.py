"""The ``batch_norm`` op rule of the port against the JAX package's, on
the CPU.

Each case builds the same Program with each package's layers: a
parameter ``x`` (so that ``append_backward`` gives ``x@GRAD``), one
``batch_norm`` over it (momentum 0.8, epsilon 1e-3), and the loss
``mean(y * r)`` with ``r`` a seeded feed, so that the gradients are not
trivially zero.  ``x``, Scale, Bias and the running statistics are
seeded numpy values copied into both scopes (statistics in [0.5, 3], so
that ``is_test`` does not see the startup's 0 and 1).  Both Executors
run the Program twice; after each run the five outputs (Y, SavedMean,
SavedVariance, MeanOut, VarianceOut) and the gradients of X, Scale and
Bias agree within 1e-6 of each tensor's largest magnitude (float32 on
both sides; XLA and torch sum the statistics in different orders), in
training and in test mode, NCHW and NHWC."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

TOL = 1e-6   # of each tensor's largest magnitude
SHAPES = {"NCHW": (4, 3, 5, 6), "NHWC": (4, 5, 6, 3)}
SLOTS = ("Y", "SavedMean", "SavedVariance", "MeanOut", "VarianceOut")


def _build(fl, is_test, layout):
    shape = list(SHAPES[layout])
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.create_parameter(shape=shape, dtype="float32", name="x")
        r = fl.layers.data(name="r", shape=shape, dtype="float32",
                           append_batch_size=False)
        y = fl.layers.batch_norm(x, is_test=is_test, data_layout=layout,
                                 momentum=0.8, epsilon=1e-3)
        loss = fl.layers.mean(fl.layers.elementwise_mul(y, r))
        params_grads = fl.backward.append_backward(loss)
    (bn,) = [op for op in main.global_block().ops if op.type == "batch_norm"]
    outs = [bn.outputs[s][0] for s in SLOTS]
    grads = [p.name + "@GRAD" for p, _ in params_grads]
    return main, startup, bn, outs, grads


def _state(main, scope, layout):
    """Seeded values for every persistable: x ~ 1 + 2 N(0, 1), the rest
    uniform in [0.5, 3]."""
    rng = np.random.RandomState(1)
    state = {}
    for n in sorted(main.persistable_names()):
        if n not in scope:
            continue
        shape = np.asarray(scope[n]).shape
        state[n] = (1 + 2 * rng.randn(*shape) if n == "x"
                    else rng.uniform(0.5, 3.0, shape)).astype("float32")
    return state


def _runs(is_test, layout):
    feed = {"r": np.random.RandomState(2).randn(*SHAPES[layout])
            .astype("float32")}
    results, state = [], None
    for fl in (jfluid, tfluid):
        main, startup, bn, outs, grads = _build(fl, is_test, layout)
        scope = fl.Scope()
        with fl.scope_guard(scope):
            exe = fl.Executor(fl.CPUPlace())
            exe.run(startup)
            if state is None:
                state = _state(main, scope, layout)
                for n, v in state.items():
                    scope[n] = v
            else:
                fl.load_numpy_state(main, state, scope=scope, device="cpu")
            runs = [[np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=outs + grads)] for _ in range(2)]
        results.append((main, bn, outs, grads, scope, runs))
    return results


@pytest.mark.parametrize("layout", list(SHAPES))
@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_batch_norm_matches_jax(is_test, layout):
    (jmain, _, _, jgrads, _, want), (tmain, bn, outs, grads, scope, got) = \
        _runs(is_test, layout)
    assert jmain.to_string() == tmain.to_string()
    assert grads == jgrads == ["x@GRAD", "batch_norm_0.w_0@GRAD",
                               "batch_norm_0.b_0@GRAD"]
    for run, (g_run, w_run) in enumerate(zip(got, want)):
        for name, g, w in zip(outs + grads, g_run, w_run):
            assert g.shape == w.shape and g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(
                g, w, rtol=0, atol=TOL * float(np.abs(w).max()),
                err_msg="%s, run %d" % (name, run))
    # the running statistics: not autograd leaves, written back to the
    # scope through MeanOut/VarianceOut (the same persistable names),
    # moved by training and passed through by test mode
    mean_name, var_name = bn.inputs["Mean"][0], bn.inputs["Variance"][0]
    assert bn.outputs["MeanOut"] == [mean_name]
    assert bn.outputs["VarianceOut"] == [var_name]
    (bw,) = [op for op in tmain.global_block().ops if op.type == "backward"]
    assert mean_name not in bw.attrs["parameter_list"]
    assert var_name not in bw.attrs["parameter_list"]
    np.testing.assert_array_equal(scope[mean_name].numpy(), got[1][3])
    np.testing.assert_array_equal(scope[var_name].numpy(), got[1][4])
    assert scope[mean_name].dtype == scope[var_name].dtype
    moved = not np.array_equal(got[0][3], got[1][3])
    assert moved != is_test


def test_batch_norm_statistics_follow_the_reference_formulas():
    """The port alone against numpy: the biased batch variance, and the
    running statistics weighing the old value by ``momentum`` (torch's
    own batch_norm would use the unbiased variance and weigh the batch
    value by its momentum)."""
    main, startup, bn, outs, _ = _build(tfluid, False, "NCHW")
    scope = tfluid.Scope()
    r = np.ones(SHAPES["NCHW"], "float32")
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        state = _state(main, scope, "NCHW")
        tfluid.load_numpy_state(main, state, scope=scope, device="cpu")
        y, sm, sv, mo, vo = exe.run(main, feed={"r": r}, fetch_list=outs)
    x = state["x"].astype(np.float64)
    m, v = x.mean((0, 2, 3)), x.var((0, 2, 3))
    np.testing.assert_allclose(sm, m, rtol=1e-6)
    np.testing.assert_allclose(sv, v, rtol=1e-6)
    np.testing.assert_allclose(
        mo, state[bn.inputs["Mean"][0]] * 0.8 + m * 0.2, rtol=1e-6)
    np.testing.assert_allclose(
        vo, state[bn.inputs["Variance"][0]] * 0.8 + v * 0.2, rtol=1e-6)
    scale = state[bn.inputs["Scale"][0]].reshape(1, -1, 1, 1)
    bias = state[bn.inputs["Bias"][0]].reshape(1, -1, 1, 1)
    want = ((x - m.reshape(1, -1, 1, 1)) / np.sqrt(v.reshape(1, -1, 1, 1)
                                                   + 1e-3) * scale + bias)
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5)
