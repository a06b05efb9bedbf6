"""The MLP of ``tests/unittests/test_mnist_mlp.py`` (fc 64 relu -> fc 10
softmax -> cross_entropy -> mean, accuracy, SGD 0.5) trained through the
port's Executor against the JAX package's, on the CPU.

Both packages build the Program from the same layer functions; the JAX
startup's parameters are copied into the port.  Over 20 SGD steps on
the same 256 seeded samples the loss stays within 1e-4 relative of the
JAX package's at every step, the accuracy within one sample, and every
parameter within 1e-4 of its tensor's largest magnitude (float32 on
both sides, summed in different orders).  The JAX startup runs with its
own ``random_seed`` (INIT_SEED), so the initial weights do not depend on
numpy's global RNG or on which test ran before.

A hidden unit u whose ReLU gate opens for a sample on one side only (its
pre-activation within rounding of 0; how often depends on the thread
counts the two libraries sum with) differs by more than any summation
tolerance covers, in the reference's own arithmetic:
- that sample's whole contribution ``x * dh_u`` passes the gate on one
  side only, so fc_0's column u and bias u move apart at once;
- from the next step on, pre-activation u differs on every sample, so
  ``h_u`` does, and so does fc_1's row u, whose gradient is
  ``h_u^T * dlogits``.
Every other fc_1 row and fc_1's bias see u only through ``dlogits``,
which ``w1[u] * dh_u`` moves by a summation-sized amount, so they stay
checked.  Such units are found from both runs' pre-activations, left out
of fc_0's column and bias check and of fc_1's row check from that step
on, and counted (at most 3).  Then the port alone passes the reference
test's own 200-step convergence asserts."""
import numpy as np

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

PARITY_STEPS = 20
TOL = 1e-4
INIT_SEED = 1   # the JAX startup's random_seed (0 would draw one)


def _make_data(n=256, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 784).astype("float32")
    w = rng.randn(784, 10).astype("float32")
    y = np.argmax(x @ w, axis=1).astype("int64").reshape(n, 1)
    return x, y


def _program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[784], dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        hidden = fl.layers.fc(input=img, size=64, act="relu")
        prediction = fl.layers.fc(input=hidden, size=10, act="softmax")
        loss = fl.layers.cross_entropy(input=prediction, label=label)
        avg_loss = fl.layers.mean(loss)
        acc = fl.layers.accuracy(input=prediction, label=label)
        fl.optimizer.SGD(learning_rate=0.5).minimize(avg_loss)
    params = [p.name for p in main.global_block().all_parameters()]
    return main, startup, avg_loss, acc, params


def _checked(name, flipped):
    """The index into parameter ``name`` of what stays checked: fc_0's
    columns and bias entries and fc_1's rows of the units not flipped."""
    if name.startswith("fc_0."):
        return (Ellipsis, ~flipped)
    if name == "fc_1.w_0":
        return ~flipped
    return slice(None)


def check_mlp_parity(init_seed):
    """The step-for-step comparison from a JAX startup run with
    ``random_seed = init_seed``; returns the units left out."""
    x, y = _make_data()
    feed = {"img": x, "label": y}
    jmain, jstart, jloss, jacc, names = _program(jfluid)
    tmain, tstart, tloss, tacc, tnames = _program(tfluid)
    assert names == tnames and len(names) == 4
    assert jmain.to_string() == tmain.to_string()
    jstart.random_seed = init_seed
    # the hidden layer's pre-activation: the relu's input
    (pre,) = [op.inputs["X"][0] for op in tmain.global_block().ops
              if op.type == "relu"]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    state = {n: np.asarray(jscope[n]) for n in jmain.persistable_names()
             if n in jscope}
    tfluid.load_numpy_state(tmain, state, scope=tscope, device="cpu")
    flipped = np.zeros(64, bool)   # hidden units whose gate differed
    for step in range(PARITY_STEPS):
        with jfluid.scope_guard(jscope):
            wl, wa, wz = jexe.run(jmain, feed=feed,
                                  fetch_list=[jloss, jacc, pre])
        with tfluid.scope_guard(tscope):
            gl, ga, gz = texe.run(tmain, feed=feed,
                                  fetch_list=[tloss, tacc, pre])
        flipped |= ((gz > 0) != (wz > 0)).any(0)
        np.testing.assert_allclose(gl, wl, rtol=TOL, atol=0,
                                   err_msg="loss, step %d" % step)
        assert abs(float(ga[0]) - float(wa[0])) <= 1.5 / len(x)
        for n in names:
            want = np.asarray(jscope[n])
            got = tscope[n].numpy()
            keep = _checked(n, flipped)
            np.testing.assert_allclose(
                got[keep], want[keep], rtol=0,
                atol=TOL * float(np.abs(want).max()),
                err_msg="%s, step %d" % (n, step))
    assert flipped.sum() <= 3, np.nonzero(flipped)
    return np.nonzero(flipped)[0]


def test_mlp_matches_jax_step_for_step():
    check_mlp_parity(INIT_SEED)


def test_mlp_trains():
    # the reference test's own convergence asserts, on the port alone
    x, y = _make_data()
    main, startup, avg_loss, acc, _ = _program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        first = None
        for _ in range(200):
            lv, av = exe.run(main, feed={"img": x, "label": y},
                             fetch_list=[avg_loss, acc])
            if first is None:
                first = float(lv[0])
        last = float(lv[0])
    assert last < first * 0.5, (first, last)
    assert float(av[0]) > 0.7
