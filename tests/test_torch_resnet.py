"""ResNet (``models.resnet``) trained through the port's Executor against
the JAX package's, on the CPU: ResNet-50 (``get_model(depth=50)``,
bottleneck blocks) at 64 x 64, batch 4, 10 classes, and the CIFAR-10
ResNet at depth 8 (``resnet_cifar10``, basic blocks) at 32 x 32.

Both packages build the same Programs (the same ``to_string()`` JSON).
The JAX startup's persistables are copied into the port, and both run
the same seeded images for two momentum steps (lr 0.01, momentum 0.9).
Each step starts the port from the JAX package's state before it
(parameters, velocities, running statistics), so each step is compared
from one state.  That is needed because the training gradient of these
nets is not a smooth function at float32 resolution: with batch
statistics over few values a channel, a ReLU gate whose input lies
within rounding of 0 opens on one side only, and one such flip moves
the gradient by whole percents
(``test_resnet50_gradient_jumps_where_a_gate_flips``).  A trajectory
run on from its own float32 gradients leaves the other one within a
step, and no summation tolerance covers that.

Limits, per step (float32 on both sides, summed in different orders):
- forward values, which no gate flip reaches: the loss 1e-4 relative;
  the softmax output 1e-4 absolute; the accuracy exact; every running
  mean and variance after the step 5e-4 of its tensor's largest
  magnitude; the label probabilities stay above 1e-6, clear of the
  reference's 1e-20 clip in ``cross_entropy``;
- the update each step makes (the new velocity, and the parameter's
  change, which is -lr times it): for fc_0, the only layer with no
  gate between it and the loss, every value 1e-3 of its tensor's
  largest |value|; for every parameter, the L2 distance 0.1 of the L2
  norm of its update (gate flips: about 2% measured), and 0.05 over
  all parameters together.
The Program cloned for test (batch_norm on the running statistics) is
compared on the state after the second step, with each running mean and
variance set to this batch's statistics, 1e-4 absolute."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import resnet as JR
from paddle_tpu_torch.models import resnet as TR

BATCH, CLASSES, LR, STEPS = 4, 10, 0.01, 2
LOSS_RTOL = 1e-4
PROB_ATOL = 1e-4
STAT_TOL = 5e-4      # of each running statistic's largest magnitude
FC_TOL = 1e-3        # of fc_0's update's largest |value|
UPDATE_L2 = 0.1      # each parameter's update, L2 relative
GLOBAL_L2 = 0.05     # all updates together, L2 relative
MIN_PROB = 1e-6


def _cifar_model(fl, R, depth=8, image_shape=(3, 32, 32)):
    """``resnet_cifar10`` wired as ``get_model`` wires ResNet-50."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        image = fl.layers.data(name="data", shape=list(image_shape),
                               dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        predict = R.resnet_cifar10(image, CLASSES, depth=depth)
        cost = fl.layers.cross_entropy(input=predict, label=label)
        avg_cost = fl.layers.mean(x=cost)
        acc = fl.layers.accuracy(input=predict, label=label)
        test = main.clone(for_test=True)
        fl.optimizer.MomentumOptimizer(learning_rate=LR, momentum=0.9
                                       ).minimize(avg_cost)
    return {"main": main, "startup": startup, "test": test, "loss": avg_cost,
            "acc": acc, "predict": predict}


MODELS = {
    "resnet50": (lambda fl, R: R.get_model(
        class_dim=CLASSES, depth=50, image_shape=(3, 64, 64), lr=LR),
        (3, 64, 64)),
    "cifar10_depth8": (_cifar_model, (3, 32, 32)),
}


def _state(prog, scope):
    return {n: np.asarray(scope[n]) for n in prog.persistable_names()
            if n in scope and scope[n] is not None}


@pytest.fixture(scope="module", params=list(MODELS))
def runs(request):
    build, shape = MODELS[request.param]
    with jfluid.unique_name.guard():
        jm = build(jfluid, JR)
    with tfluid.unique_name.guard():
        tm = build(tfluid, TR)
    jm["startup"].random_seed = 5
    rng = np.random.RandomState(7)
    feed = {"data": rng.rand(BATCH, *shape).astype("float32"),
            "label": rng.randint(0, CLASSES, (BATCH, 1)).astype("int64")}
    blk = jm["main"].global_block()
    params = [p.name for p in blk.all_parameters() if p.trainable]
    stats = [p.name for p in blk.all_parameters() if not p.trainable]
    fetch = ["loss", "acc", "predict"]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jm["startup"])
    steps = []
    for _ in range(STEPS):
        before = _state(jm["main"], jscope)
        tscope = tfluid.Scope()
        tfluid.load_numpy_state(tm["main"], before, scope=tscope,
                                device="cpu")
        with jfluid.scope_guard(jscope):
            want = jexe.run(jm["main"], feed=feed,
                            fetch_list=[jm[k] for k in fetch])
        got = texe.run(tm["main"], feed=feed,
                       fetch_list=[tm[k] for k in fetch], scope=tscope)
        steps.append({"before": before,
                      "jax": (want, _state(jm["main"], jscope)),
                      "port": (got, _state(tm["main"], tscope))})
    # the test Program on the state after the steps, each batch_norm's
    # running statistics (named through the op's Mean and Variance
    # inputs) set to the port's batch statistics of this batch, so that
    # the softmax is not saturated as it is on the startup's 0 and 1
    state = _state(jm["main"], jscope)
    bns = [op for op in tm["main"].global_block().ops
           if op.type == "batch_norm"]
    saved = texe.run(tm["main"], feed=feed, scope=tscope, fetch_list=[
        op.outputs[s][0] for op in bns
        for s in ("SavedMean", "SavedVariance")])
    for k, op in enumerate(bns):
        state[op.inputs["Mean"][0]] = saved[2 * k]
        state[op.inputs["Variance"][0]] = saved[2 * k + 1]
    for n, v in state.items():
        jscope[n] = v
    with jfluid.scope_guard(jscope):
        jtest = jexe.run(jm["test"], feed=feed, fetch_list=[jm["predict"]])[0]
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tm["main"], state, scope=tscope, device="cpu")
    ttest = texe.run(tm["test"], feed=feed, fetch_list=[tm["predict"]],
                     scope=tscope)[0]
    return {"name": request.param, "programs": (jm, tm), "feed": feed,
            "params": params, "stats": stats, "steps": steps,
            "test": (jtest, ttest)}


def test_programs_serialize_identically(runs):
    jm, tm = runs["programs"]
    for name in ("main", "startup", "test"):
        assert jm[name].to_string() == tm[name].to_string(), name
    types = {op.type for op in tm["main"].global_block().ops}
    assert types == {"accuracy", "backward", "batch_norm", "conv2d",
                     "cross_entropy", "elementwise_add", "mean", "momentum",
                     "mul", "pool2d", "relu", "softmax", "top_k"}
    n_bn = sum(op.type == "batch_norm" for op in tm["main"].global_block().ops)
    assert n_bn == {"resnet50": 53, "cifar10_depth8": 9}[runs["name"]]
    assert all(op.attrs["is_test"] for op in tm["test"].global_block().ops
               if op.type == "batch_norm")


def test_forward_matches_jax_each_step(runs):
    label = runs["feed"]["label"][:, 0]
    for i, step in enumerate(runs["steps"]):
        (wl, wa, wp), wstate = step["jax"]
        (gl, ga, gp), gstate = step["port"]
        np.testing.assert_allclose(gl, wl, rtol=LOSS_RTOL, atol=0,
                                   err_msg="loss, step %d" % i)
        np.testing.assert_array_equal(ga, wa, err_msg="accuracy, step %d" % i)
        np.testing.assert_allclose(gp, wp, rtol=0, atol=PROB_ATOL,
                                   err_msg="softmax, step %d" % i)
        assert wp[np.arange(BATCH), label].min() > MIN_PROB, i
        for n in runs["stats"]:
            w, g = wstate[n], gstate[n]
            assert not np.array_equal(w, step["before"][n]), n
            np.testing.assert_allclose(
                g, w, rtol=0, atol=STAT_TOL * float(np.abs(w).max()),
                err_msg="%s, step %d" % (n, i))


def test_updates_match_jax_each_step(runs):
    for i, step in enumerate(runs["steps"]):
        before = step["before"]
        (_, wstate), (_, gstate) = step["jax"], step["port"]
        num = den = 0.0
        for p in runs["params"]:
            vel = p + "_velocity_0"
            assert gstate[vel].shape == before[p].shape, vel
            for want, got, what in (
                    (wstate[p] - before[p], gstate[p] - before[p], p),
                    (wstate[vel], gstate[vel], vel)):
                assert np.isfinite(got).all(), what
                dist = float(np.linalg.norm(got - want))
                norm = float(np.linalg.norm(want))
                assert norm > 0, what   # every parameter moves
                assert dist <= UPDATE_L2 * norm, (what, i, dist / norm)
                if p.startswith("fc_0."):
                    np.testing.assert_allclose(
                        got, want, rtol=0,
                        atol=FC_TOL * float(np.abs(want).max()),
                        err_msg="%s, step %d" % (what, i))
            num += float(np.sum((gstate[vel] - wstate[vel]) ** 2))
            den += float(np.sum(wstate[vel] ** 2))
        assert num <= GLOBAL_L2 ** 2 * den, (i, (num / den) ** 0.5)


def test_test_program_matches_jax(runs):
    jtest, ttest = runs["test"]
    assert ttest.shape == (BATCH, CLASSES)
    assert jtest.max() < 1 - 1e-3   # no row saturated to one class
    np.testing.assert_allclose(ttest, jtest, rtol=0, atol=PROB_ATOL)


def test_resnet50_gradient_jumps_where_a_gate_flips():
    """Why each step starts from one state: the port in float64, from one
    set of weights, with the images moved by 1e-12 and by 1e-7 relative
    (float32's rounding).  The first moves the gradient by rounding only;
    the second flips ReLU gates and moves the gradient by more than
    UPDATE_L2 / 10 (L2, over all parameters)."""
    with tfluid.unique_name.guard():
        m = TR.get_model(class_dim=CLASSES, depth=50,
                         image_shape=(3, 64, 64), dtype="float64")
    m["startup"].random_seed = 5
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(m["startup"], scope=scope)
    state = _state(m["main"], scope)
    blk = m["main"].global_block()
    grads = [p.name + "@GRAD" for p in blk.all_parameters() if p.trainable]
    gates = [op.inputs["X"][0] for op in blk.ops if op.type == "relu"]
    rng = np.random.RandomState(7)
    x = rng.rand(BATCH, 3, 64, 64)
    label = rng.randint(0, CLASSES, (BATCH, 1)).astype("int64")
    noise = rng.randn(*x.shape)
    outs = []
    for eps in (0.0, 1e-12, 1e-7):
        scope = tfluid.Scope()
        tfluid.load_numpy_state(m["main"], state, scope=scope, device="cpu")
        outs.append(exe.run(m["main"], scope=scope,
                            feed={"data": x * (1 + eps * noise),
                                  "label": label},
                            fetch_list=grads + gates))

    def moved(o):
        g0 = np.concatenate([a.ravel() for a in outs[0][:len(grads)]])
        g = np.concatenate([a.ravel() for a in o[:len(grads)]])
        flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in
                    zip(outs[0][len(grads):], o[len(grads):]))
        return float(np.linalg.norm(g - g0) / np.linalg.norm(g0)), flips

    (tiny, tiny_flips), (f32_sized, flips) = moved(outs[1]), moved(outs[2])
    assert tiny_flips == 0 and tiny < 1e-8, (tiny, tiny_flips)
    assert flips > 0 and f32_sized > UPDATE_L2 / 10, (f32_sized, flips)


def test_load_numpy_state_carries_every_resnet_weight():
    """``load_numpy_state`` carries the JAX startup's conv and fc weights,
    batch_norm's Scale and Bias and its running mean and variance, and the
    momentum velocities into the port, bit for bit, in their dtypes."""
    with jfluid.unique_name.guard():
        jm = _cifar_model(jfluid, JR)
    with tfluid.unique_name.guard():
        tm = _cifar_model(tfluid, TR)
    jm["startup"].random_seed = 5
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jm["startup"])
    state = _state(jm["main"], jscope)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tm["main"], state, scope=tscope, device="cpu")
    (bn,) = [op for op in tm["main"].global_block().ops
             if op.type == "batch_norm"][:1]
    names = {
        "conv weight": "conv2d_0.w_0",
        "batch_norm scale": bn.inputs["Scale"][0],
        "batch_norm offset": bn.inputs["Bias"][0],
        "running mean": bn.inputs["Mean"][0],
        "running variance": bn.inputs["Variance"][0],
        "fc weight": "fc_0.w_0",
        "fc bias": "fc_0.b_0",
        "velocity": "conv2d_0.w_0_velocity_0",
    }
    assert list(names.values()) == [
        "conv2d_0.w_0", "batch_norm_0.w_0", "batch_norm_0.b_0",
        "batch_norm_0.w_1", "batch_norm_0.w_2", "fc_0.w_0", "fc_0.b_0",
        "conv2d_0.w_0_velocity_0"]
    for what, n in names.items():
        got = tscope[n]
        assert got.dtype == tfluid.core.torch_dtype(
            tm["main"].global_block().var(n).dtype), what
        np.testing.assert_array_equal(got.numpy(), state[n], err_msg=what)
    assert not np.array_equal(state[names["batch_norm scale"]],
                              state[names["running mean"]])
    every = [n for n in tm["main"].persistable_names() if n in state]
    assert len(every) == len(state)
    for n in every:
        np.testing.assert_array_equal(tscope[n].numpy(), state[n], err_msg=n)
