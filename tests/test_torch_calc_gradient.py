"""``backward.calc_gradient`` through the port's Executor against the JAX
package's, on the CPU: the cases of
``tests/unittests/test_calc_gradient_op.py`` (a leaf feed, an
intermediate variable where the graph is cut, an explicit cotangent that
is held constant and bound as the target's gradient), several targets
and inputs at once with a parameter among them, and the reference's
``KeyError``s.  Values within 1e-6 relative of the JAX package's."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def _run(fl, build, feeds):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        fetch = build(fl)
    exe = fl.Executor(fl.CPUPlace())
    with fl.scope_guard(fl.Scope()):
        exe.run(startup)
        return exe.run(main, feed=feeds, fetch_list=fetch)


def _both(build, feeds):
    want = _run(jfluid, build, feeds)
    got = _run(tfluid, build, feeds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    return got


def test_grad_wrt_leaf_feed():
    xv = np.array([[1.0, 2.0], [3.0, -1.0]], "float32")

    def build(fl):
        x = fl.layers.data(name="x", shape=[2], dtype="float32", stop_gradient=False)
        y = fl.layers.reduce_sum(fl.layers.square(x))
        (gx,) = fl.backward.calc_gradient(y, [x])
        return [gx]

    (gx,) = _both(build, {"x": xv})
    np.testing.assert_allclose(gx, 2 * xv, rtol=1e-6)


def test_grad_wrt_intermediate_var():
    xv = np.array([[0.5, -1.0, 2.0]], "float32")

    def build(fl):
        x = fl.layers.data(name="x", shape=[3], dtype="float32", stop_gradient=False)
        y = fl.layers.scale(x, scale=3.0)
        z = fl.layers.reduce_sum(fl.layers.square(y))
        (gy,) = fl.backward.calc_gradient(z, [y])
        return [gy]

    (gy,) = _both(build, {"x": xv})
    np.testing.assert_allclose(gy, 2 * (3 * xv), rtol=1e-6)


def test_explicit_cotangent_is_constant_and_bound():
    xv = np.array([[1.0, 2.0, 0.5]], "float32")

    def build(fl):
        x = fl.layers.data(name="x", shape=[3], dtype="float32", stop_gradient=False)
        t = fl.layers.square(x)
        cot = fl.layers.scale(x, scale=2.0)
        (gx,) = fl.backward.calc_gradient(t, [x], target_gradients=[cot])
        return [gx, t.name + "@GRAD"]

    gx, tgrad = _both(build, {"x": xv})
    np.testing.assert_allclose(gx, (2 * xv) * (2 * xv), rtol=1e-6)
    np.testing.assert_allclose(tgrad, 2 * xv, rtol=1e-6)


def test_two_targets_and_a_parameter():
    xv = np.random.RandomState(0).randn(4, 3).astype("float32")

    def build(fl):
        x = fl.layers.data(name="x", shape=[3], dtype="float32", stop_gradient=False)
        h = fl.layers.fc(x, size=2, bias_attr=False,
                         param_attr=fl.ParamAttr(
                             name="w", initializer=fl.initializer.Constant(0.5)))
        a = fl.layers.reduce_sum(fl.layers.square(h))
        b = fl.layers.mean(x)
        w = fl.default_main_program().global_block().var("w")
        return fl.backward.calc_gradient([a, b], [x, w, h])

    gx, gw, gh = _both(build, {"x": xv})
    h = xv @ np.full((3, 2), 0.5, "float32")
    np.testing.assert_allclose(gh, 2 * h, rtol=1e-5)
    assert gw.shape == (3, 2) and gx.shape == (4, 3)


@pytest.mark.parametrize("fl", [jfluid, tfluid], ids=["jax", "port"])
def test_missing_inputs_and_targets_raise_key_error(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[3], dtype="float32", stop_gradient=False)
        y = fl.layers.reduce_sum(fl.layers.square(x))
        ghost = main.global_block().create_var(name="ghost", shape=[3],
                                               dtype="float32")
        fl.backward.calc_gradient(y, [ghost])
    exe = fl.Executor(fl.CPUPlace())
    with pytest.raises(KeyError, match="inputs not available"):
        exe.run(main, feed={"x": np.ones((1, 3), "float32")},
                scope=fl.Scope())
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[3], dtype="float32", stop_gradient=False)
        ghost = main.global_block().create_var(name="ghost", shape=[1],
                                               dtype="float32")
        fl.backward.calc_gradient(ghost, [x])
    with pytest.raises(KeyError, match="targets not produced"):
        exe.run(main, feed={"x": np.ones((1, 3), "float32")},
                scope=fl.Scope())
