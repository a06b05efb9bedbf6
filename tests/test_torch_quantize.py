"""The port's quantization (``contrib.quantize`` and the rules of
``ops/quant_ops.py``) against the JAX package's on the CPU.

Each op case builds the same one-op Program with each package's layers
(the op appended raw) and runs both Executors on the same seeded numpy
feed.  The int8 products are exact in integer arithmetic, and the
quantization and rescale are the same float32 operations in the same
order, so ``quantized_mul``, ``quantized_conv2d`` and the fake quant's
forward are held bitwise.  The card's route (``torch._int_mm`` on
operands padded to its limits, the convolution's im2col operand written
in place) is driven here against a stand-in for ``torch._int_mm`` that
checks those limits and multiplies on the CPU: bitwise the plain version.

The transpilers: ``Int8InferenceTranspiler`` on the reference test's
net gives the JAX package's op list, int8 weights, scales and logits
bitwise; the reference test's quantize-aware training story holds, its
losses within 1e-5 relative of the JAX package's.  R-16: a conv +
batch_norm net folded and then quantized keeps the fold's ``Bias`` (the
reference's transpiler would drop it), its int8 logits within
``INT8_FOLD_L2`` of the folded float32 logits.  ``freeze_program`` writes
the weights in place and leaves a bound step bound.  The int8 Program
saved, loaded and exported (``aot=True``) predicts its own bits.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texe
from paddle_tpu_torch.ops import quant_ops
from test_torch_ops import _pair
from test_torch_detection_ops import _op

CPU = tfluid.CPUPlace()

#: quantized_mul cases: (rows, K, N, x_num_col_dims); a leading 3-D shape
#: for x_num_col_dims 2
MUL_CASES = {
    "rows_under_17": ((5, 24), 16, 1),
    "rows_256": ((256, 64), 24, 1),
    "n_not_multiple_of_8": ((32, 20), 10, 1),
    "k_odd": ((19, 13), 8, 1),
    "x_num_col_dims_2": ((4, 6, 12), 10, 2),
}

#: quantized_conv2d cases: (N, C, H, W, O, k, stride, pad, dilation,
#: groups)
CONV_CASES = {
    "resnet_stem": (2, 3, 20, 20, 8, 7, 2, 3, 1, 1),
    "3x3_c64": (2, 64, 8, 8, 16, 3, 1, 1, 1, 1),
    "3x3_strided": (2, 16, 9, 9, 8, 3, 2, 1, 1, 1),
    "1x1_256_to_64": (2, 256, 4, 4, 64, 1, 1, 0, 1, 1),
    "dilated": (1, 5, 13, 13, 6, 3, 1, 2, 2, 1),
    "grouped": (2, 8, 7, 7, 6, 3, 1, 1, 1, 2),
}

#: the relative L2 distance of a small folded net's int8 logits from its
#: folded float32 logits.  Each quantization (per-tensor activations,
#: per-channel weights) rounds to 1/254 of its range, a uniform error of
#: about 0.0023 of the range in RMS; an activation's range is 3-4 times
#: its RMS, so each layer adds about 1% in L2, and three quantized
#: layers about 2%.  The limit leaves twice that
INT8_FOLD_L2 = 0.05


def _quant_op(fl, op_type, feeds, attrs, out_slot, bf16=False):
    """``op_type`` appended raw over data variables named as ``feeds``'
    slots (``X``/``Input`` cast to bfloat16 where ``bf16``)."""
    ins = {}
    for slot, arr in feeds.items():
        v = fl.layers.data(name=slot.lower(), shape=list(arr.shape),
                           dtype=str(arr.dtype), append_batch_size=False)
        if bf16 and slot in ("X", "Input"):
            v = fl.layers.cast(v, "bfloat16")
        ins[slot] = v
    return _op(fl, op_type, ins, {out_slot: "float32"}, attrs)


def _feed(feeds):
    return {slot.lower(): arr for slot, arr in feeds.items()}


def _mul_feeds(case, seed=0):
    xshape, n, _ = MUL_CASES[case]
    r = np.random.RandomState(seed)
    k = int(np.prod(xshape[MUL_CASES[case][2]:]))
    return {"X": r.randn(*xshape).astype("float32"),
            "QWeight": r.randint(-127, 128, (k, n)).astype("int8"),
            "WScale": r.uniform(0.01, 2.0, n).astype("float32")}


def _conv_feeds(case, seed=1):
    n, c, h, w, o, k, _, _, _, groups = CONV_CASES[case]
    r = np.random.RandomState(seed)
    return {"Input": r.randn(n, c, h, w).astype("float32"),
            "QWeight": r.randint(-127, 128, (o, c // groups, k, k))
            .astype("int8"),
            "WScale": r.uniform(0.01, 2.0, o).astype("float32")}


def _conv_attrs(case):
    _, _, _, _, _, _, s, p, d, g = CONV_CASES[case]
    return {"strides": [s, s], "paddings": [p, p], "dilations": [d, d],
            "groups": g}


def _bitwise(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes(), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MUL_CASES))
def test_quantized_mul_is_bitwise_jax(case, dtype):
    feeds = _mul_feeds(case)
    attrs = {"x_num_col_dims": MUL_CASES[case][2]}
    (want,), (got,) = _pair(lambda fl: _quant_op(
        fl, "quantized_mul", feeds, attrs, "Out", dtype == "bfloat16"),
        _feed(feeds))
    _bitwise(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_quantized_conv2d_is_bitwise_jax(case, dtype):
    feeds = _conv_feeds(case)
    (want,), (got,) = _pair(lambda fl: _quant_op(
        fl, "quantized_conv2d", feeds, _conv_attrs(case), "Output",
        dtype == "bfloat16"), _feed(feeds))
    _bitwise(got, want)


def test_quantized_conv2d_adds_its_bias_r16():
    """R-16: the rule adds a ``Bias`` input, in float32 after the
    rescale; the JAX package's rule reads none."""
    feeds = _conv_feeds("3x3_strided")
    attrs = _conv_attrs("3x3_strided")
    (want,), _ = _pair(lambda fl: _quant_op(
        fl, "quantized_conv2d", feeds, attrs, "Output"), _feed(feeds))
    with_bias = dict(feeds, Bias=np.random.RandomState(2).randn(8)
                     .astype("float32"))
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        (out,) = _quant_op(tfluid, "quantized_conv2d", with_bias, attrs,
                           "Output")
    (got,) = tfluid.Executor(CPU).run(main, feed=_feed(with_bias),
                                      fetch_list=[out], scope=tfluid.Scope())
    _bitwise(got, np.asarray(want) + with_bias["Bias"].reshape(1, -1, 1, 1))


def test_fake_quantize_forward_is_bitwise_jax_and_its_gradient_upstream():
    x = np.random.RandomState(3).randn(6, 4, 3, 3).astype("float32")
    g = np.random.RandomState(4).randn(6, 4, 3, 3).astype("float32")

    def build(fl):
        xv = fl.layers.data(name="x", shape=list(x.shape), dtype="float32",
                            append_batch_size=False, stop_gradient=False)
        gv = fl.layers.data(name="g", shape=list(g.shape), dtype="float32",
                            append_batch_size=False)
        out, scale = _op(fl, "fake_quantize_abs_max", {"X": xv},
                         {"Out": "float32", "OutScale": "float32"},
                         {"bit_length": 8})
        loss = fl.layers.reduce_sum(fl.layers.elementwise_mul(out, gv))
        return [out, scale] + fl.backward.calc_gradient(loss, [xv])

    (jout, jscale, jgrad), (tout, tscale, tgrad) = _pair(
        build, {"x": x, "g": g})
    _bitwise(tout, jout)
    _bitwise(tscale, jscale)
    assert tscale.shape == (1,)
    _bitwise(tgrad, g)
    _bitwise(jgrad, g)
    # the forward is x + (qdq - x): at most 4 levels of 2 * scale / 254
    levels = np.round(x / jscale[0] * 127.0)
    assert np.abs(tout - levels / 127.0 * jscale[0]).max() <= 1e-6


def _stand_in_int_mm(calls):
    """``quant_ops._int_mm`` on the CPU: checks the operands against
    ``torch._int_mm``'s CUDA limits and the K-major layouts, then
    multiplies with the CPU's ``torch._int_mm``."""

    def int_mm(a, b_t, rows, cols):
        assert a.dtype == b_t.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[0] == rows + quant_ops.PAD_ROWS
        assert a.shape[1] % 8 == 0 and b_t.shape[0] % 8 == 0
        assert a.shape[1] == b_t.shape[1]
        assert a.is_contiguous() and b_t.is_contiguous()
        # the pad rows and columns are zeros
        assert not a[rows:].any() and not b_t[cols:].any()
        calls.append((tuple(a.shape), tuple(b_t.shape)))
        return torch._int_mm(a, b_t.t())[:rows, :cols]

    return int_mm


@pytest.mark.parametrize("case", list(CONV_CASES) + list(MUL_CASES))
def test_card_route_is_bitwise_the_plain_version(case, monkeypatch):
    """The CUDA route's padding and layouts, on the CPU: with a stand-in
    for ``torch._int_mm``, every case equals the plain version bitwise,
    and every GEMM met its limits."""
    if case in CONV_CASES:
        f = _conv_feeds(case)
        attrs = _conv_attrs(case)
        args = (torch.as_tensor(quant_ops.quantize_activation(
            torch.as_tensor(f["Input"]))[0]), torch.as_tensor(f["QWeight"]),
            (attrs["strides"][0],) * 2, (attrs["paddings"][0],) * 2,
            (attrs["dilations"][0],) * 2, attrs["groups"])
        run = quant_ops.int8_conv2d
    else:
        f = _mul_feeds(case)
        xn = MUL_CASES[case][2]
        x = torch.as_tensor(f["X"])
        x2 = x.reshape(int(np.prod(x.shape[:xn])), -1)
        args = (quant_ops.quantize_activation(x2)[0],
                torch.as_tensor(f["QWeight"]).t())
        run = quant_ops.int8_matmul
    want = run(*args)
    calls = []
    monkeypatch.setattr(quant_ops, "_plain", lambda t: False)
    monkeypatch.setattr(quant_ops, "_int_mm", _stand_in_int_mm(calls))
    got = run(*args)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    groups = CONV_CASES[case][-1] if case in CONV_CASES else 1
    assert len(calls) == groups


def test_int_mm_refuses_a_device_it_has_no_route_for():
    a = torch.zeros((17, 8), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="neither on the CPU"):
        quant_ops.int8_matmul(a, torch.zeros((8, 8), dtype=torch.int8,
                                             device="meta"))


def _build_net(fl):
    """The reference test's net (tests/unittests/test_int8_inference.py):
    conv 3x3 -> relu -> pool -> fc 32 relu -> fc 10 softmax."""
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 7
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        c = fl.layers.conv2d(img, num_filters=8, filter_size=3, act="relu")
        p = fl.layers.pool2d(c, pool_size=2, pool_stride=2)
        f = fl.layers.fc(p, size=32, act="relu")
        out = fl.layers.fc(f, size=10, act="softmax")
    return main, startup, out


def _logits_name(prog):
    return next(op.inputs["X"][0] for op in prog.global_block().ops
                if op.type == "softmax")


def test_int8_transpile_of_the_reference_net_is_bitwise_jax():
    x = np.random.RandomState(0).randn(4, 3, 16, 16).astype("float32")
    results = {}
    state = None
    for fl in (jfluid, tfluid):
        main, startup, out = _build_net(fl)
        infer = main.clone(for_test=True)
        scope = fl.Scope()
        with fl.scope_guard(scope):
            exe = fl.Executor(fl.CPUPlace())
            exe.run(startup)
            if state is None:
                state = {n: np.asarray(scope[n])
                         for n in main.persistable_names() if n in scope}
            else:
                fl.load_numpy_state(main, state, scope=scope, device="cpu")
            fl.contrib.quantize.Int8InferenceTranspiler().transpile(
                infer, scope)
            logits = _logits_name(infer)
            got = exe.run(infer, feed={"img": x}, fetch_list=[logits, out])
        results[fl] = {
            "ops": [(op.type, op.inputs, op.outputs)
                    for op in infer.global_block().ops],
            "q": {n: texe.as_numpy(scope[n]) for n in infer.persistable_names()
                  if n.endswith((".int8", ".scale"))},
            "out": [np.asarray(o) for o in got]}
    j, t = results[jfluid], results[tfluid]
    assert t["ops"] == j["ops"]
    types = [op[0] for op in t["ops"]]
    assert types.count("quantized_conv2d") == 1
    assert types.count("quantized_mul") == 2
    assert sorted(t["q"]) == sorted(j["q"]) and len(t["q"]) == 6
    for n in j["q"]:
        assert t["q"][n].dtype == j["q"][n].dtype
        assert t["q"][n].tobytes() == j["q"][n].tobytes(), n
    _bitwise(t["out"][0], j["out"][0])
    np.testing.assert_allclose(t["out"][1], j["out"][1], rtol=1e-6,
                               atol=1e-7)


def _qat(fl, state=None, steps=60):
    """The reference test's quantize-aware training story: an MLP trained
    with fake-quantized weights (Adam, 60 steps), frozen, then run int8.
    Returns (losses, the frozen float predictions, the int8 predictions,
    labels, the startup state)."""
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype("float32")
    W_true = rng.randn(8, 4)
    Y = np.argmax(X @ W_true, axis=1).reshape(-1, 1).astype("int64")
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 5
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[8], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        h = fl.layers.fc(x, size=16, act="relu")
        p = fl.layers.fc(h, size=4, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=p, label=y))
        fl.optimizer.Adam(learning_rate=5e-2).minimize(loss)
        infer = main.clone(for_test=True)
    qt = fl.contrib.quantize.QuantizeTranspiler()
    qt.training_transpile(main)
    exe = fl.Executor(fl.CPUPlace())
    scope = fl.Scope()
    with fl.scope_guard(scope):
        exe.run(startup)
        if state is None:
            state = {n: np.asarray(scope[n]) for n in main.persistable_names()
                     if n in scope}
        else:
            fl.load_numpy_state(main, state, scope=scope, device="cpu")
        losses = [float(np.asarray(exe.run(
            main, feed={"x": X, "y": Y}, fetch_list=[loss])[0]).reshape(-1)[0])
            for _ in range(steps)]
        qt.freeze_program(main, scope)
        infer = infer.prune([p])
        (float_pred,) = exe.run(infer, feed={"x": X}, fetch_list=[p])
        fl.contrib.quantize.Int8InferenceTranspiler().transpile(infer, scope)
        (int8_pred,) = exe.run(infer, feed={"x": X}, fetch_list=[p])
    return (np.array(losses), np.asarray(float_pred), np.asarray(int8_pred),
            Y, state, main)


def test_qat_freeze_int8_story_matches_jax():
    jl, _, ji, Y, state, jmain = _qat(jfluid)
    tl, tf, ti, _, _, tmain = _qat(tfluid, state)
    ops = [op.type for op in tmain.global_block().ops]
    assert ops.count("fake_quantize_abs_max") == 2
    assert ops == [op.type for op in jmain.global_block().ops]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    float_acc = (tf.argmax(1).reshape(-1, 1) == Y).mean()
    int8_acc = (ti.argmax(1).reshape(-1, 1) == Y).mean()
    assert float_acc > 0.8, float_acc
    assert int8_acc >= float_acc - 0.05, (float_acc, int8_acc)
    np.testing.assert_allclose(ti, ji, rtol=1e-4, atol=1e-5)


def _conv_bn_net(fl):
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 13
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[3, 12, 12], dtype="float32")
        h = fl.layers.conv2d(x, num_filters=8, filter_size=3, padding=1,
                             bias_attr=False)
        h = fl.layers.batch_norm(h, act="relu")
        h = fl.layers.conv2d(h, num_filters=16, filter_size=3, stride=2,
                             padding=1, bias_attr=False)
        h = fl.layers.batch_norm(h, act="relu")
        out = fl.layers.fc(h, size=10, act="softmax")
    return main.clone(for_test=True), startup, out


def test_fold_then_int8_keeps_the_bias_r16():
    test, startup, _ = _conv_bn_net(tfluid)
    logits = _logits_name(test)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(5)
    for op in test.global_block().ops:
        if op.type == "batch_norm":
            for slot in ("Scale", "Bias", "Mean", "Variance"):
                n = op.inputs[slot][0]
                scope[n] = torch.as_tensor(rng.uniform(
                    0.5, 3.0, tuple(scope[n].shape)).astype("float32"))
    x = rng.randn(8, 3, 12, 12).astype("float32")
    tfluid.InferenceTranspiler().transpile(test, CPU, scope)
    folded = np.asarray(exe.run(test, feed={"x": x}, fetch_list=[logits],
                                scope=scope)[0])
    tfluid.contrib.quantize.Int8InferenceTranspiler().transpile(test, scope)
    qconvs = [op for op in test.global_block().ops
              if op.type == "quantized_conv2d"]
    assert len(qconvs) == 2 and all(op.inputs.get("Bias") for op in qconvs)
    int8 = np.asarray(exe.run(test, feed={"x": x}, fetch_list=[logits],
                              scope=scope)[0])

    def l2(a):
        return float(np.linalg.norm(a - folded) / np.linalg.norm(folded))

    assert l2(int8) < INT8_FOLD_L2, l2(int8)
    # without the fold's shift (the reference's transpiler) the logits
    # move far past the limit
    for op in qconvs:
        del op.inputs["Bias"]
    test._bump()
    dropped = np.asarray(exe.run(test, feed={"x": x}, fetch_list=[logits],
                                 scope=scope)[0])
    assert l2(dropped) > 4 * INT8_FOLD_L2, l2(dropped)


def test_freeze_writes_in_place_and_the_step_stays_bound():
    """``freeze_program`` overwrites each weight's tensor in place (the
    JAX package's dequantized values, bitwise), so the quantize-aware
    step bound before it replays after it: no new capture.
    ``convert_to_int8`` puts the int8 weights and scales on the weight's
    device."""
    from paddle_tpu.contrib.quantize import quantize_transpiler as JQ

    main, startup = tfluid.Program(), tfluid.Program()
    startup.random_seed = 3
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(
            tfluid.layers.fc(x, size=16, act="relu"), size=4))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    qt = tfluid.contrib.quantize.QuantizeTranspiler()
    qt.training_transpile(main)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(1).randn(16, 8).astype("float32")}
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    before = {n: scope[n] for n in scope.keys()}
    raw = {n: texe.as_numpy(scope[n]) for n in ("fc_0.w_0", "fc_1.w_0")}
    version, c0 = scope._version, texe.compile_count()
    qt.freeze_program(main, scope)
    assert scope._version == version
    assert all(scope[n] is t for n, t in before.items())
    for n, w in raw.items():
        want = JQ.dequantize_weight_abs_max(
            *JQ.quantize_weight_abs_max(w)).astype("float32")
        assert texe.as_numpy(scope[n]).tobytes() == want.tobytes(), n
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert texe.compile_count() == c0
    qt.convert_to_int8(main, scope)
    q = scope["fc_0.w_0.int8"]
    assert q.dtype == torch.int8 and q.device == scope["fc_0.w_0"].device
    assert scope["fc_0.w_0.scale"].dtype == torch.float32


def test_int8_program_saves_loads_and_exports(tmp_path):
    """The int8 Program saved by ``io.save_inference_model`` loads back
    with its weights int8 and runs bitwise; with ``aot=True`` the
    ``torch.export`` artifact (a symbolic batch) predicts the Program's
    bits at two batch sizes."""
    main, startup, out = _build_net(tfluid)
    infer = main.clone(for_test=True)
    scope, exe = tfluid.Scope(), tfluid.Executor(CPU)
    x = np.random.RandomState(8).randn(6, 3, 16, 16).astype("float32")
    with tfluid.scope_guard(scope):
        exe.run(startup)
        tfluid.contrib.quantize.Int8InferenceTranspiler().transpile(
            infer, scope)
        want = {n: np.asarray(exe.run(infer, feed={"img": x[:n]},
                                      fetch_list=[out])[0]) for n in (6, 2)}
        tfluid.io.save_inference_model(str(tmp_path), ["img"], [out], exe,
                                       main_program=infer, aot=True)
    loaded = tfluid.Scope()
    with tfluid.scope_guard(loaded):
        prog, feeds, fetches = tfluid.io.load_inference_model(str(tmp_path),
                                                              exe)
        got = exe.run(prog, feed={"img": x}, fetch_list=fetches)[0]
    assert feeds == ["img"]
    assert np.asarray(got).tobytes() == want[6].tobytes()
    assert loaded["conv2d_0.w_0.int8"].dtype == torch.int8
    predict, _, _ = tfluid.io.load_aot_inference_model(str(tmp_path),
                                                       device="cpu")
    for n in (6, 2):
        assert np.asarray(predict({"img": x[:n]})[0]).tobytes() == \
            want[n].tobytes()
