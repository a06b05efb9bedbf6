"""VGG-16, SE-ResNeXt-50, word2vec and DeepFM (``models.vgg``,
``models.se_resnext``, ``models.word2vec``, ``models.deepfm``) trained
through the port's Executor against the JAX package's, on the CPU (DeepFM
and ``bilinear_interp``'s ``OutSize`` in their own sections below):
- VGG-16 with batch norm at 3 x 32 x 32, batch 4, 10 classes, Adam;
- SE-ResNeXt-50 at 3 x 64 x 64, batch 2, 10 classes, momentum.  At
  32 x 32 its last stage is 1 x 1, so each of its batch_norms
  normalizes 2 values a channel, and a rounding-level change in a
  channel's two inputs moves the output by up to 1/sqrt(epsilon) times
  as much: there the port's own float32 loss is 6.8% from its float64
  loss on the same state and images, and no float32 comparison can
  hold.  At 64 x 64 (2 x 2, 8 values a channel) the two are within
  6.1e-6;
- SE-ResNeXt-101 and 152: their Programs only (the same JSON);
- the word2vec n-gram model with the softmax head, vocab 100, batch 16,
  Adam; its NCE and hierarchical-sigmoid heads, each trained on its own
  trajectory beside the JAX package's (their test's docstring).

Both packages build the same Programs (the same ``to_string()`` JSON).
Every dropout's ``dropout_prob`` is then set to 0 in both packages'
Programs, because the two draw from different generators by
construction.  The port's startup state (seeded) is copied into both
packages; the JAX package's startup is not run, since compiling it costs
more than the steps (9.3 s for VGG-16 and 17.3 s for SE-ResNeXt-50 on
an 8-core Xeon) and the steps are what is compared.  Both run the same seeded
feed for two steps, each starting the port from the JAX package's state
before it, as ``tests/test_torch_resnet.py`` does and for its reason:
with batch statistics over few values, a ReLU gate within rounding of 0
opens on one side only and moves the gradient by whole percents, so a
trajectory run on from its own float32 gradients leaves the other.

Limits, per step (``tests/test_torch_resnet.py``'s): the loss 1e-4
relative, the softmax output 1e-4 absolute, the accuracy exact, every
running mean and variance 5e-4 of its tensor's largest magnitude; the
optimizer's first accumulator (velocity, or Adam's first moment) of the
last fc's weight, which no gate separates from the loss, 1e-3 of its
largest |value|; for every parameter, the L2 distance of each of its
accumulators 0.1 of their L2 norm, and 0.05 over all first accumulators
together; with momentum, the update (-lr times the velocity) the same.
Adam's update is held through its moments (the gradient and its square)
and not by itself: a first step moves each element by lr times the sign
of its gradient, so an element whose gradient is at rounding level moves
by +-lr in either package at random.  One kind of parameter has such
gradients throughout: a bias added just before a batch_norm (VGG's conv
and fc biases), whose true gradient is 0 because the batch_norm takes
the mean out.  Their first moments must be at rounding level in both
packages, under 1e-5 of their layer's weight's largest.
The Program cloned for test is compared on the state after the second
step (each running mean and variance set to the batch's statistics),
1e-4 absolute.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texe, observability as tobs
from paddle_tpu.models import se_resnext as JS, vgg as JV, word2vec as JW
from paddle_tpu_torch.models import se_resnext as TS, vgg as TV, word2vec as TW

STEPS = 2
LOSS_RTOL = 1e-4
PROB_ATOL = 1e-4
STAT_TOL = 5e-4      # of each running statistic's largest magnitude
LAST_FC_TOL = 1e-3   # of the last fc's first accumulator's largest |value|
UPDATE_L2 = 0.1      # each update and accumulator, L2 relative
GLOBAL_L2 = 0.05     # all first accumulators together, L2 relative
NOISE = 1e-5         # a zero-gradient bias's first moment, of its weight's
VOCAB, W2V_BATCH = 100, 16

MODELS = {
    "vgg16": (lambda fl, M: M.get_model(class_dim=10, image_shape=(3, 32, 32)),
              (JV, TV), 4, (3, 32, 32)),
    "se_resnext50": (lambda fl, M: M.get_model(class_dim=10, depth=50,
                                               image_shape=(3, 64, 64)),
                     (JS, TS), 2, (3, 64, 64)),
    "word2vec": (lambda fl, M: M.get_model(vocab_size=VOCAB), (JW, TW),
                 W2V_BATCH, None),
}


def _no_dropout(m):
    for name in ("main", "test"):
        for op in m[name].global_block().ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0


def _state(prog, scope):
    return {n: np.array(scope[n]) for n in prog.persistable_names()
            if n in scope and scope[n] is not None}


def _feed(m, batch, shape):
    rng = np.random.RandomState(7)
    if shape is None:
        return {n: rng.randint(0, VOCAB, (batch, 1)).astype("int64")
                for n in m["feeds"]}
    return {m["feeds"][0]: rng.rand(batch, *shape).astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}


def _fetch_keys(m):
    return ["loss", "acc", "predict"] if "acc" in m else ["loss"]


@pytest.fixture(scope="module", params=list(MODELS))
def runs(request):
    build, (JM, TM), batch, shape = MODELS[request.param]
    with jfluid.unique_name.guard():
        jm = build(jfluid, JM)
    with tfluid.unique_name.guard():
        tm = build(tfluid, TM)
    serialized = {k: (jm[k].to_string(), tm[k].to_string())
                  for k in ("main", "startup", "test")}
    for m in (jm, tm):
        _no_dropout(m)
    tm["startup"].random_seed = 5
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.run(tm["startup"], scope=tscope)
    state = _state(tm["main"], tscope)
    feed = _feed(tm, batch, shape)
    keys = _fetch_keys(tm)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, v in state.items():
        jscope[n] = v
    steps = []
    for _ in range(STEPS):
        before = _state(jm["main"], jscope)
        tscope = tfluid.Scope()
        tfluid.load_numpy_state(tm["main"], before, scope=tscope, device="cpu")
        with jfluid.scope_guard(jscope):
            want = jexe.run(jm["main"], feed=feed,
                            fetch_list=[jm[k] for k in keys])
        got = texe.run(tm["main"], feed=feed, fetch_list=[tm[k] for k in keys],
                       scope=tscope)
        steps.append({"before": before,
                      "jax": ([np.asarray(w) for w in want],
                              _state(jm["main"], jscope)),
                      "port": ([np.asarray(g) for g in got],
                               _state(tm["main"], tscope))})
    # the test Program on the state after the steps, each batch_norm's
    # running statistics set to the port's batch statistics of this batch
    state = _state(jm["main"], jscope)
    bns = [op for op in tm["main"].global_block().ops
           if op.type == "batch_norm"]
    if bns:
        saved = texe.run(tm["main"], feed=feed, scope=tscope, fetch_list=[
            op.outputs[s][0] for op in bns
            for s in ("SavedMean", "SavedVariance")])
        for k, op in enumerate(bns):
            state[op.inputs["Mean"][0]] = saved[2 * k]
            state[op.inputs["Variance"][0]] = saved[2 * k + 1]
    for n, v in state.items():
        jscope[n] = v
    out = keys[-1]
    with jfluid.scope_guard(jscope):
        jtest = jexe.run(jm["test"], feed=feed, fetch_list=[jm[out]])[0]
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tm["main"], state, scope=tscope, device="cpu")
    ttest = texe.run(tm["test"], feed=feed, fetch_list=[tm[out]],
                     scope=tscope)[0]
    blk = tm["main"].global_block()
    muls = [op for op in blk.ops if op.type == "mul"]
    return {"name": request.param, "programs": (jm, tm),
            "serialized": serialized, "feed": feed, "keys": keys,
            "params": [p.name for p in blk.all_parameters() if p.trainable],
            "stats": [p.name for p in blk.all_parameters() if not p.trainable],
            "last_fc": muls[-1].inputs["Y"][0], "steps": steps,
            "test": (np.asarray(jtest), np.asarray(ttest))}


def test_programs_serialize_identically(runs):
    for name, (j, t) in runs["serialized"].items():
        assert j == t, name
    jm, tm = runs["programs"]
    types = {op.type for op in tm["main"].global_block().ops}
    assert {"vgg16": {"batch_norm", "conv2d", "pool2d", "dropout", "adam"},
            "se_resnext50": {"batch_norm", "conv2d", "sigmoid",
                             "elementwise_mul", "momentum"},
            "word2vec": {"lookup_table", "concat", "sigmoid", "adam"},
            }[runs["name"]] <= types
    assert all(op.attrs["is_test"] for op in tm["test"].global_block().ops
               if op.type in ("batch_norm", "dropout"))


def test_forward_matches_jax_each_step(runs):
    for i, step in enumerate(runs["steps"]):
        want, wstate = step["jax"]
        got, gstate = step["port"]
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL, atol=0,
                                   err_msg="loss, step %d" % i)
        if len(want) == 3:
            np.testing.assert_array_equal(got[1], want[1],
                                          err_msg="accuracy, step %d" % i)
            np.testing.assert_allclose(got[2], want[2], rtol=0, atol=PROB_ATOL,
                                       err_msg="softmax, step %d" % i)
        for n in runs["stats"]:
            w, g = wstate[n], gstate[n]
            assert not np.array_equal(w, step["before"][n]), n
            np.testing.assert_allclose(
                g, w, rtol=0, atol=STAT_TOL * float(np.abs(w).max()),
                err_msg="%s, step %d" % (n, i))


def _l2_rel(got, want):
    return float(np.linalg.norm(got - want)), float(np.linalg.norm(want))


def _biases_before_batch_norm(program):
    """{bias: its layer's weight} for each parameter added to a conv or
    fc output that goes straight into a batch_norm."""
    ops = program.global_block().ops
    made = {n: op for op in ops for ns in op.outputs.values() for n in ns}
    params = {p.name for p in program.global_block().all_parameters()}
    out = {}
    for op in ops:
        add = made.get(op.inputs["X"][0]) if op.type == "batch_norm" else None
        if add is not None and add.type == "elementwise_add" and \
                add.inputs["Y"][0] in params:
            layer = made[add.inputs["X"][0]]
            weight = (layer.inputs.get("Filter") or layer.inputs["Y"])[0]
            out[add.inputs["Y"][0]] = weight
    return out


def test_updates_match_jax_each_step(runs):
    _, tm = runs["programs"]
    ops = tm["main"].global_block().ops
    adam = any(op.type == "adam" for op in ops)
    zero_grad = _biases_before_batch_norm(tm["main"])
    assert bool(zero_grad) is (runs["name"] == "vgg16")
    for i, step in enumerate(runs["steps"]):
        before = step["before"]
        (_, wstate), (_, gstate) = step["jax"], step["port"]
        num = den = 0.0
        for p in runs["params"]:
            accs = sorted(n for n in wstate if n.startswith(p + "_")
                          and wstate[n].shape == before[p].shape)
            assert accs, p
            first = accs[0]   # moment1 or velocity
            if p in zero_grad:
                w = wstate[zero_grad[p] + first[len(p):]]
                for state in (wstate, gstate):
                    assert np.abs(state[first]).max() <= \
                        NOISE * np.abs(w).max(), (first, i)
                continue
            pairs = [] if adam else [
                (wstate[p] - before[p], gstate[p] - before[p], p)]
            pairs += [(wstate[a], gstate[a], a) for a in accs]
            for want, got, what in pairs:
                assert got.shape == want.shape and np.isfinite(got).all(), what
                dist, norm = _l2_rel(got, want)
                assert norm > 0, what   # every parameter moves
                assert dist <= UPDATE_L2 * norm, (what, i, dist / norm)
            if p == runs["last_fc"]:
                np.testing.assert_allclose(
                    gstate[first], wstate[first], rtol=0,
                    atol=LAST_FC_TOL * float(np.abs(wstate[first]).max()),
                    err_msg="%s, step %d" % (first, i))
            num += float(np.sum((gstate[first] - wstate[first]) ** 2))
            den += float(np.sum(wstate[first] ** 2))
            # the scalar accumulators (Adam's beta powers) exactly
            for n in wstate:
                if n.startswith(p + "_") and wstate[n].size == 1:
                    np.testing.assert_allclose(gstate[n], wstate[n], rtol=1e-6)
        assert num <= GLOBAL_L2 ** 2 * den, (i, (num / den) ** 0.5)


def test_test_program_matches_jax(runs):
    want, got = runs["test"]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


#: the word2vec NCE head's negatives in both packages' mains (they draw
#: from different generators by construction), a repeated class among them
W2V_NEGATIVES = [3, 17, 17, 42, 64, 0, 99, 8]


def _fixed_negatives(main):
    for op in main.global_block().ops:
        if op.type == "nce":
            op.attrs["custom_neg_classes"] = list(W2V_NEGATIVES)


@pytest.mark.parametrize("loss_type,op_type", [("nce", "nce"),
                                               ("hsigmoid", "hierarchical_sigmoid")])
def test_word2vec_sampled_heads_build_the_reference_and_raise(loss_type,
                                                              op_type):
    """The NCE and hierarchical-sigmoid heads (which raised, naming their
    op, until the port had its rules) build the reference's Programs and
    train as the JAX package's: the port's seeded startup state in both,
    the NCE head's negatives set to W2V_NEGATIVES in both mains (an
    ``edit`` of the Program, as ``test_torch_ops._pair`` takes one), then
    STEPS + 1 Adam steps on one seeded batch, each package on its own
    trajectory (no gate and no batch statistic: each step is a smooth
    function of its state): each loss within LOSS_RTOL and falling, and
    every persistable after the steps within 1e-4 of its tensor's largest
    magnitude.  A weight row no step reaches stays put in both."""
    with jfluid.unique_name.guard():
        jm = JW.get_model(loss_type=loss_type, vocab_size=VOCAB)
    with tfluid.unique_name.guard():
        tm = TW.get_model(loss_type=loss_type, vocab_size=VOCAB)
    for k in ("main", "startup", "test"):
        assert jm[k].to_string() == tm[k].to_string(), k
    assert op_type in {op.type for op in tm["main"].global_block().ops}
    for m in (jm, tm):
        _fixed_negatives(m["main"])
    tm["startup"].random_seed = 5
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tm["startup"], scope=tscope)
    start = _state(tm["main"], tscope)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, v in start.items():
        jscope[n] = v
    feed = _feed(tm, W2V_BATCH, None)
    losses = []
    for _ in range(STEPS + 1):
        with jfluid.scope_guard(jscope):
            (want,) = jexe.run(jm["main"], feed=feed, fetch_list=[jm["loss"]])
        (got,) = texe.run(tm["main"], feed=feed, fetch_list=[tm["loss"]],
                          scope=tscope)
        losses.append((float(np.asarray(want).reshape(-1)[0]),
                       float(np.asarray(got).reshape(-1)[0])))
    for want, got in losses:
        assert np.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want), \
            losses
    assert losses[-1][1] < losses[0][1]
    wstate, gstate = _state(jm["main"], jscope), _state(tm["main"], tscope)
    assert sorted(wstate) == sorted(gstate)
    for n, w in wstate.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(gstate[n].astype("float64") - w).max()) / scale
        assert err <= 1e-4, (n, err)
    (head,) = [op for op in tm["main"].global_block().ops
               if op.type == op_type]
    weight = (head.inputs.get("Weight") or head.inputs["W"])[0]
    moved = np.abs(gstate[weight] - start[weight]).max(axis=1) > 0
    assert 0 < moved.sum() < len(moved)
    assert np.array_equal(moved, np.abs(wstate[weight] - start[weight])
                          .max(axis=1) > 0)


@pytest.mark.parametrize("depth", [101, 152])
def test_se_resnext_deeper_depths_build_the_reference(depth):
    programs = []
    for fl, M in ((jfluid, JS), (tfluid, TS)):
        with fl.unique_name.guard():
            m = M.get_model(class_dim=10, depth=depth, image_shape=(3, 64, 64))
        programs.append([m[k].to_string() for k in ("main", "startup", "test")])
    assert programs[0] == programs[1]


# ---------------------------------------------------------------------------
# DeepFM (models.deepfm) at test_distributed_pserver.py's small size: 6
# fields of 100 ids, batch 64, Adam 0.01.  Both packages build the same
# Programs; the JAX startup's state is copied into the port and both run
# the same 4 seeded batches on from there: each step's loss and AUC, and
# every persistable after it (the AUC's StatPos/StatNeg histograms
# included), within 1e-5 of each tensor's largest magnitude.  A histogram
# count moves whole when a sample's score crosses a bin edge, so these
# hold exactly: the seeded scores lie at least 1.3e-3 of a bin (about 5
# float32 ulps) from an edge, out of reach of the packages' rounding
# differences.  Then the
# port's fast path: the 4 steps bound (1 entry, 1 capture) give the bits
# of the same steps run op by op.
# ---------------------------------------------------------------------------

DEEPFM = dict(sparse_feature_dim=100, num_fields=6, lr=0.01)
DEEPFM_BATCH, DEEPFM_STEPS, DEEPFM_RTOL = 64, 4, 1e-5


def _deepfm_feed(step):
    rng = np.random.RandomState(40 + step)
    ids = rng.randint(0, 100, size=(DEEPFM_BATCH, 6)).astype("int64")
    w = np.random.RandomState(39).randn(100) * 0.5
    label = (w[ids].sum(1) + 0.2 * rng.randn(DEEPFM_BATCH) > 0)
    return {"feat_ids": ids, "label": label.astype("float32").reshape(-1, 1)}


@pytest.fixture(scope="module")
def deepfm():
    from paddle_tpu.models import deepfm as JD
    from paddle_tpu_torch.models import deepfm as TD

    with jfluid.unique_name.guard():
        jm = JD.get_model(**DEEPFM)
    with tfluid.unique_name.guard():
        tm = TD.get_model(**DEEPFM)
    # the startup's own seed: with none the JAX package draws one from
    # numpy's global generator, which the tests run before move
    jm["startup"].random_seed = 5
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jm["startup"])
    start = _state(jm["main"], jscope)
    steps = []
    for step in range(DEEPFM_STEPS):
        with jfluid.scope_guard(jscope):
            out = jexe.run(jm["main"], feed=_deepfm_feed(step),
                           fetch_list=[jm["loss"], jm["auc"]])
        steps.append(([np.asarray(o) for o in out], _state(jm["main"], jscope)))
    return {"programs": (jm, tm), "start": start, "steps": steps}


def _deepfm_port_steps(tm, start, use_program_cache):
    scope = tfluid.Scope()
    tfluid.load_numpy_state(tm["main"], start, scope=scope, device="cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    before = texe.compile_count()
    steps = []
    for step in range(DEEPFM_STEPS):
        out = exe.run(tm["main"], feed=_deepfm_feed(step),
                      fetch_list=[tm["loss"], tm["auc"]], scope=scope,
                      use_program_cache=use_program_cache)
        steps.append(([np.array(o) for o in out], _state(tm["main"], scope)))
    return steps, len(exe._bound), texe.compile_count() - before


def test_deepfm_programs_serialize_identically(deepfm):
    jm, tm = deepfm["programs"]
    for k in ("main", "startup", "test"):
        assert jm[k].to_string() == tm[k].to_string(), k
    assert {op.type for op in tm["main"].global_block().ops} == {
        "adam", "auc", "backward", "cast", "elementwise_add", "elementwise_mul",
        "elementwise_sub", "lookup_table", "mean", "mul", "reduce_sum", "relu",
        "reshape", "scale", "sigmoid", "sigmoid_cross_entropy_with_logits"}


def test_deepfm_matches_jax_for_four_steps(deepfm):
    _, tm = deepfm["programs"]
    port, _, _ = _deepfm_port_steps(tm, deepfm["start"], True)
    stats = [n for n in deepfm["start"] if "_stat_" in n]
    assert len(stats) == 2
    for step, ((want, wstate), (got, gstate)) in enumerate(
            zip(deepfm["steps"], port)):
        for name, g, w in zip(("loss", "auc"), got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=DEEPFM_RTOL, atol=0,
                                       err_msg="%s, step %d" % (name, step))
        assert set(gstate) == set(wstate)
        for n in wstate:
            np.testing.assert_allclose(
                gstate[n], wstate[n], rtol=0,
                atol=DEEPFM_RTOL * float(np.abs(wstate[n]).max()),
                err_msg="%s, step %d" % (n, step))
        # the histograms count every sample seen so far
        assert sum(gstate[n].sum() for n in stats) == DEEPFM_BATCH * (step + 1)


def test_deepfm_binds_and_replays_bitwise(deepfm):
    _, tm = deepfm["programs"]
    fast, bound, captures = _deepfm_port_steps(tm, deepfm["start"], True)
    slow, _, slow_captures = _deepfm_port_steps(tm, deepfm["start"], False)
    assert (bound, captures, slow_captures) == (1, 1, 0)
    for (fo, fs), (so, ss) in zip(fast, slow):
        for a, b in zip(fo, so):
            assert a.tobytes() == b.tobytes()
        assert set(fs) == set(ss)
        for n in fs:
            assert fs[n].tobytes() == ss[n].tobytes(), n


# ---------------------------------------------------------------------------
# bilinear_interp's OutSize input: read back to the host at every run, so
# a Program that feeds one runs op by op (never bound); one that sets
# out_h/out_w binds.  The JAX package cannot run an OutSize at all (it
# reads the value while tracing its step: ROADMAP R-6), so the port's
# answer is held against the JAX package's Program with the same size in
# out_h/out_w.
# ---------------------------------------------------------------------------


def _resize_program(fl, out_size):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[2, 3, 8, 8], dtype="float32",
                           append_batch_size=False)
        inputs = {"X": [x]}
        if out_size:
            inputs["OutSize"] = [fl.layers.data(
                name="size", shape=[2], dtype="int32", append_batch_size=False)]
        helper = fl.layer_helper.LayerHelper("bilinear_interp")
        out = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(type="bilinear_interp", inputs=inputs,
                         outputs={"Out": [out]}, attrs={"out_h": 5, "out_w": 7})
    return main, out


def test_bilinear_out_size_runs_op_by_op_and_matches_jax():
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype("float32")
    jmain, jout = _resize_program(jfluid, False)
    with jfluid.scope_guard(jfluid.Scope()):
        want = np.asarray(jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, feed={"x": x}, fetch_list=[jout])[0])
    jsized, jsout = _resize_program(jfluid, True)
    with pytest.raises(Exception, match="[Tt]rac"):
        with jfluid.scope_guard(jfluid.Scope()):
            jfluid.Executor(jfluid.CPUPlace()).run(
                jsized, feed={"x": x, "size": np.array([5, 7], "int32")},
                fetch_list=[jsout])
    main, out = _resize_program(tfluid, True)
    refused = tobs.counter("executor.graph_refused", {"op": "bilinear_interp"})
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    r0, c0 = refused.value, texe.compile_count()
    for size in ([5, 7], [4, 4], [5, 7]):
        got = np.asarray(exe.run(main, feed={"x": x, "size": np.array(size, "int32")},
                                 fetch_list=[out], scope=scope)[0])
        assert got.shape == (2, 3, *size)
        if size == [5, 7]:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert refused.value - r0 == 3 and texe.compile_count() == c0
    assert not exe._bound


def test_bilinear_without_out_size_binds():
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype("float32")
    main, out = _resize_program(tfluid, False)
    assert texe._graph_refusal(main, {}, [out.name]) is None
    outs = []
    for cache in (True, False):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        c0 = texe.compile_count()
        outs.append([np.array(exe.run(main, feed={"x": x}, fetch_list=[out],
                                      scope=scope, use_program_cache=cache)[0])
                     for _ in range(3)])
        assert (len(exe._bound), texe.compile_count() - c0) == \
            ((1, 1) if cache else (0, 0))
    assert all(a.tobytes() == b.tobytes() for a, b in zip(*outs))
