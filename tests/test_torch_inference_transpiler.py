"""The port's InferenceTranspiler (the conv+BN and mul+BN fold) on the
CPU, against the port's own unfolded Program and the JAX package's.

Each Program is built with each package's layers and cloned for test,
so that batch_norm runs on its running statistics.  Those statistics,
Scale and Bias are set to seeded values in [0.5, 3] through the
batch_norm op's ``Scale``, ``Bias``, ``Mean`` and ``Variance`` inputs
(not by variable names, which hold no "mean" or "variance"), so that
the fold has a shift to carry.  Limits (float32; the fold reassociates
``(x*w - mean) * k + bias`` as ``x*(w*k) + (bias - mean*k)``): 2e-5 of
the unfolded output's largest magnitude, against the port's unfolded
Program and the JAX package's.

The JAX package's fold drops the shift for a conv or mul with no bias,
because its conv2d and mul rules never read the ``Bias`` input that the
fold adds; ``test_the_reference_fold_drops_the_shift`` shows it, and
why the port departs from the reference here.  A folded model saved by
the port, ``aot=True``, loads back on the CPU and predicts the folded
Program's bits."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import resnet as JR
from paddle_tpu_torch.models import resnet as TR

TOL = 2e-5   # of the unfolded output's largest magnitude
BATCH = 4


def _conv_bn(fl, R):
    x = fl.layers.data(name="x", shape=[3, 9, 9], dtype="float32")
    conv = fl.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                            bias_attr=False)
    return x, fl.layers.batch_norm(conv, act="relu")


def _mul_bn(fl, R):
    x = fl.layers.data(name="x", shape=[12], dtype="float32")
    h = fl.layers.fc(x, size=6, bias_attr=False)
    return x, fl.layers.batch_norm(h)


def _cifar(fl, R):
    x = fl.layers.data(name="x", shape=[3, 32, 32], dtype="float32")
    return x, R.resnet_cifar10(x, 10, depth=8)


CASES = {"conv_bn": (_conv_bn, (3, 9, 9), 1),
         "mul_bn": (_mul_bn, (12,), 1),
         "cifar10_depth8": (_cifar, (3, 32, 32), 9)}


def _build(fl, R, case):
    """The test Program, its startup and the name of the output compared:
    the softmax's input where the net ends in one (its output saturates
    on these statistics)."""
    build = CASES[case][0]
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        _, out = build(fl, R)
    startup.random_seed = 11
    test = main.clone(for_test=True)
    name = next((op.inputs["X"][0] for op in test.global_block().ops
                 if op.type == "softmax" and op.outputs["Out"] == [out.name]),
                out.name)
    return test, startup, name


def _stats(test, scope):
    """Seeded values in [0.5, 3] for every batch_norm's Scale, Bias, Mean
    and Variance, found through the op's inputs."""
    rng = np.random.RandomState(3)
    vals = {}
    for op in test.global_block().ops:
        if op.type == "batch_norm":
            for slot in ("Scale", "Bias", "Mean", "Variance"):
                name = op.inputs[slot][0]
                shape = np.asarray(scope[name]).shape
                vals[name] = rng.uniform(0.5, 3.0, shape).astype("float32")
    return vals


def _jax_outputs(case, x, fold):
    test, startup, out = _build(jfluid, JR, case)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        state = {n: np.asarray(scope[n]) for n in test.persistable_names()
                 if n in scope}
        state.update(_stats(test, scope))
        for n, v in state.items():
            scope[n] = v
        unfolded = exe.run(test, feed={"x": x}, fetch_list=[out])[0]
        folded = None
        if fold:
            jfluid.InferenceTranspiler().transpile(test, jfluid.CPUPlace(),
                                                   scope)
            folded = exe.run(test, feed={"x": x}, fetch_list=[out])[0]
    return state, unfolded, folded


def _port(case, state):
    """The port's test Program (unfolded) and a second one folded, each
    with its own scope holding ``state``."""
    progs = []
    for fold in (False, True):
        test, _, out = _build(tfluid, TR, case)
        scope = tfluid.Scope()
        tfluid.load_numpy_state(test, state, scope=scope, device="cpu")
        if fold:
            tfluid.InferenceTranspiler().transpile(test, tfluid.CPUPlace(),
                                                   scope)
        progs.append((test, scope, out))
    return progs


def _input(case):
    return np.random.RandomState(4).randn(BATCH, *CASES[case][1]).astype(
        "float32")


@pytest.mark.parametrize("case", list(CASES))
def test_fold_matches_the_unfolded_program(case):
    x = _input(case)
    state, jax_unfolded, _ = _jax_outputs(case, x, fold=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    (plain, pscope, pout), (folded, fscope, fout) = _port(case, state)
    unfolded = exe.run(plain, feed={"x": x}, fetch_list=[pout],
                       scope=pscope)[0]
    got = exe.run(folded, feed={"x": x}, fetch_list=[fout], scope=fscope)[0]
    ops = [op.type for op in folded.global_block().ops]
    assert "batch_norm" not in ops
    assert ops.count("conv2d") + ops.count("mul") >= CASES[case][2]
    assert sum(bool(op.inputs.get("Bias")) for op in folded.global_block().ops
               if op.type in ("conv2d", "mul")) == CASES[case][2]
    scale = float(np.abs(unfolded).max())
    np.testing.assert_allclose(got, unfolded, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(got, jax_unfolded, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(unfolded, jax_unfolded, rtol=0,
                               atol=TOL * scale)
    # the unfolded Program's weights are untouched in its own scope
    for n, v in state.items():
        np.testing.assert_array_equal(pscope[n].numpy(), v)


def test_the_reference_fold_drops_the_shift():
    """The JAX package's folded conv+BN Program differs from its unfolded
    one by more than 0.1 (its conv2d rule never reads the ``Bias`` its
    fold adds); the port's does not."""
    x = _input("conv_bn")
    state, jax_unfolded, jax_folded = _jax_outputs("conv_bn", x, fold=True)
    assert float(np.abs(jax_folded - jax_unfolded).max()) > 0.1
    exe = tfluid.Executor(tfluid.CPUPlace())
    folded, fscope, fout = _port("conv_bn", state)[1]
    got = exe.run(folded, feed={"x": x}, fetch_list=[fout], scope=fscope)[0]
    np.testing.assert_allclose(got, jax_unfolded, rtol=0,
                               atol=TOL * float(np.abs(jax_unfolded).max()))


def test_folded_model_round_trips_through_aot(tmp_path):
    case = "cifar10_depth8"
    x = _input(case)
    state, _, _ = _jax_outputs(case, x, fold=False)
    folded, scope, out = _port(case, state)[1]
    exe = tfluid.Executor(tfluid.CPUPlace())
    want = exe.run(folded, feed={"x": x}, fetch_list=[out], scope=scope)[0]
    d = str(tmp_path / "folded")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, ["x"], [out], exe,
                                       main_program=folded, aot=True)
    predict, feeds, fetches = tfluid.io.load_aot_inference_model(
        d, device="cpu")
    assert feeds == ["x"] and fetches == [out]
    np.testing.assert_array_equal(predict({"x": x})[0], want)
    # the Program backend reads the folded biases back from the directory
    with tfluid.scope_guard(tfluid.Scope()):
        prog, feed_names, targets = tfluid.io.load_inference_model(d, exe)
        assert not any(op.type == "batch_norm"
                       for op in prog.global_block().ops)
        got = exe.run(prog, feed={"x": x}, fetch_list=targets)[0]
    np.testing.assert_array_equal(got, want)
