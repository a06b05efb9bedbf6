"""MNIST LeNet (``models.mnist.get_model``: conv 5x5x20 -> max pool 2 ->
conv 5x5x50 -> max pool 2 -> fc 10 softmax, cross entropy, Adam 1e-3)
trained through the port's Executor against the JAX package's, on the
CPU, at batch 8.

Both packages build the same Programs (the same ``to_string()`` JSON);
the JAX startup's parameters are copied into the port.  The images are
seeded synthetic 1x28x28 arrays whose labels come from a fixed random
linear teacher (as ``test_mnist_mlp.py``'s data), fed through each
package's ``DataFeeder``.  Over 3 Adam steps the loss stays within 1e-4
relative of the JAX package's, and every step-1 ``<param>@GRAD`` within
1e-3 of its tensor's largest |g| (float32; convolutions and GEMMs sum in
different orders).  The Program cloned for test predicts what the
training Program's forward predicts on the same parameters."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import mnist as JM
from paddle_tpu_torch.models import mnist as TM

BATCH = 8
STEPS = 3
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3


def synthetic_mnist(n, seed):
    """``n`` seeded (image [1, 28, 28] float32, label int) samples, each
    label the argmax of a fixed random linear teacher over the image."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 28, 28).astype("float32")
    w = np.random.RandomState(1234).randn(784, 10).astype("float32")
    y = np.argmax((x.reshape(n, 784) - 0.5) @ w, axis=1)
    return [(x[i], int(y[i])) for i in range(n)]


@pytest.fixture(scope="module")
def runs():
    with jfluid.unique_name.guard():
        jm = JM.get_model(batch_size=BATCH)
    with tfluid.unique_name.guard():
        tm = TM.get_model(batch_size=BATCH)
    grads = [p.name + "@GRAD"
             for p in jm["main"].global_block().all_parameters()]
    batches = [synthetic_mnist(BATCH, seed) for seed in range(STEPS)]
    out = {"programs": (jm, tm), "grad_names": grads}
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jm["startup"])
        state = {n: np.asarray(jscope[n]) for n in jm["main"].persistable_names()
                 if n in jscope}
        feeder = jfluid.DataFeeder(jm["feeds"], jfluid.CPUPlace(),
                                   program=jm["main"])
        test0 = exe.run(jm["test"], feed=feeder.feed(batches[0]),
                        fetch_list=[jm["predict"]])[0]
        res = [exe.run(jm["main"], feed=feeder.feed(b),
                       fetch_list=[jm["loss"], jm["predict"]] + grads)
               for b in batches]
    out["jax"] = res, test0
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tm["startup"])
        tfluid.load_numpy_state(tm["main"], state, device="cpu")
        feeder = tfluid.DataFeeder(tm["feeds"], tfluid.CPUPlace(),
                                   program=tm["main"])
        test0 = exe.run(tm["test"], feed=feeder.feed(batches[0]),
                        fetch_list=[tm["predict"]])[0]
        res = [exe.run(tm["main"], feed=feeder.feed(b),
                       fetch_list=[tm["loss"], tm["predict"]]
                       + (grads if i == 0 else []))
               for i, b in enumerate(batches)]
        out["params_moved"] = all(
            not np.array_equal(tscope[n].numpy(), state[n])
            for n in state if n.endswith(("w_0", "b_0")))
    out["port"] = res, test0
    return out


def test_programs_serialize_identically(runs):
    jm, tm = runs["programs"]
    for name in ("main", "startup", "test"):
        assert jm[name].to_string() == tm[name].to_string(), name
    assert {op.type for op in tm["main"].global_block().ops} >= {
        "conv2d", "pool2d", "cross_entropy", "mean", "top_k", "accuracy",
        "adam"}


def test_losses_match_jax_over_adam_steps(runs):
    want = [float(r[0][0]) for r in runs["jax"][0]]
    got = [float(r[0][0]) for r in runs["port"][0]]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    assert runs["params_moved"]


def test_step1_gradients_match_jax(runs):
    names = runs["grad_names"]
    assert len(names) == 6   # two convs and the fc, weights and biases
    for name, g, w in zip(names, runs["port"][0][0][2:], runs["jax"][0][0][2:]):
        assert g.shape == w.shape, name
        tol = GRAD_TOL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)


def test_test_program_predicts_as_the_forward(runs):
    (res, test0), (jres, jtest0) = runs["port"], runs["jax"]
    assert test0.shape == (BATCH, 10)
    # the first step's forward ran on the same parameters as the test run
    np.testing.assert_array_equal(test0, res[0][1])
    np.testing.assert_allclose(test0, jtest0, rtol=0, atol=1e-5)
