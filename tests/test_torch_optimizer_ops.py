"""The port's update rules against the JAX package's, on the CPU.

Each case trains one [4, 3] parameter whose gradient the feed sets
exactly (loss = sum(param * g), so dL/dparam = g), built with each
package's ``fluid.optimizer`` class from the same initial value, and
runs three steps on the same seeded feeds: after every step the
parameter and every accumulator agree within 1e-6 of the tensor's
largest magnitude (float32 on both sides; XLA may fuse an update into
other instruction orders).  ``average_accumulate`` is ModelAverage's
rule, built after SGD's minimize.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

SHAPE = (4, 3)
STEPS = 3
RTOL = 1e-6

#: name -> (optimizer class name, its kwargs); ModelAverage rides on SGD
RULES = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9)),
    "momentum_nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                           use_nesterov=True)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1, epsilon=1e-6)),
    "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=0.1, decay=0.9)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9, epsilon=1e-6)),
    "adamax": ("Adamax", dict(learning_rate=0.1, beta1=0.8, beta2=0.95)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.05, rho=0.9, momentum=0.5)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.05, rho=0.9,
                                         momentum=0.5, centered=True)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.05, l2=0.1)),
    "ftrl_power": ("Ftrl", dict(learning_rate=0.1, l1=0.05, l2=0.1,
                                lr_power=-0.7)),
    "average_accumulate": ("SGD", dict(learning_rate=0.1)),
}


def _trajectory(fl, name, p0, grads):
    cls, kw = RULES[name]
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        g = fl.layers.data(name="g", shape=[SHAPE[1]], dtype="float32")
        w = fl.layers.create_parameter(
            shape=list(SHAPE), dtype="float32", name="w",
            default_initializer=fl.initializer.NumpyArrayInitializer(p0))
        loss = fl.layers.reduce_sum(fl.layers.elementwise_mul(w, g))
        getattr(fl.optimizer, cls)(**kw).minimize(loss)
        if name == "average_accumulate":
            fl.optimizer.ModelAverage(0.15, min_average_window=1,
                                      max_average_window=100)
    ops = {op.type for op in main.global_block().ops}
    names = sorted(n for n in main.persistable_names()
                   if n not in ("feed", "fetch"))
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope()
    out = []
    with fl.scope_guard(scope):
        exe.run(startup)
        for g_t in grads:
            exe.run(main, feed={"g": g_t}, fetch_list=[loss])
            out.append({n: np.array(scope[n]) for n in names if n in scope})
    return ops, out


@pytest.mark.parametrize("name", list(RULES))
def test_update_rule_matches_jax(name):
    rng = np.random.RandomState(0)
    p0 = rng.uniform(-1, 1, SHAPE).astype("float32")
    grads = [rng.uniform(-1, 1, SHAPE).astype("float32") for _ in range(STEPS)]
    jops, want = _trajectory(jfluid, name, p0, grads)
    tops, got = _trajectory(tfluid, name, p0, grads)
    rule = name.split("_nesterov")[0].split("_centered")[0].split("_power")[0]
    assert rule in tops and tops == jops
    for step, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w) and len(g) >= 2, (sorted(g), sorted(w))
        for n in w:
            wv = np.asarray(w[n])
            assert g[n].shape == wv.shape, n
            if not np.issubdtype(wv.dtype, np.floating):
                np.testing.assert_array_equal(g[n], wv, err_msg=n)
                continue
            tol = RTOL * max(float(np.abs(wv).max()), 1e-30)
            np.testing.assert_allclose(g[n], wv, rtol=0, atol=tol,
                                       err_msg="%s, step %d" % (n, step))
    assert not np.array_equal(got[-1]["w"], p0)
