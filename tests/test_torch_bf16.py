"""bfloat16 through the port against the JAX package, on the CPU.

The op rules that bench.py's bf16 legs run, one op at a time: each case
builds the same one-op Program in both packages (its inputs fed as
seeded numpy, bfloat16 as ml_dtypes arrays), runs both Executors and
compares every output slot.
- ResNet-50's rules: conv2d, batch_norm, pool2d, relu, elementwise_add,
  mul, softmax, cross_entropy, mean, accuracy, top_k and momentum.
- Transformer-base's: lookup_table, layer_norm, matmul, mul,
  flash_attention, softmax_with_cross_entropy, dropout, scale, the
  elementwise ops and adam.
Each output keeps the JAX package's dtype: bfloat16 where the rule casts
back to its input's, float32 where the JAX rule keeps a float32
intermediate (batch_norm's saved statistics, the accumulators written by
the update rules, accuracy), integers as integers (the JAX package runs
with x64 off, so its int64 outputs come back int32: only the kind is
compared).  Values:
- elementwise rules (relu, add, mul, div, min, scale, softmax, the
  losses, layer_norm, batch_norm's Y, pooling, mean, the update rules'
  parameter): within one bf16 ulp of the JAX value (XLA may keep an
  intermediate in float32 where torch rounds it, and the last bit of a
  transcendental differs between the two libraries; a bf16 ulp is 2**-7
  of the value's power of two);
- products and convolutions (mul, matmul, conv2d, flash_attention),
  which both packages sum in float32 in different orders before one
  rounding: within 2 bf16 ulps;
- float32 outputs (statistics, accumulators): 1e-6 of their largest
  magnitude; integer outputs exactly.

Then the repairs and the models:
- F-10: ``layer_norm`` with bfloat16 ``Scale`` and ``Bias`` (it raised);
- F-11: ``_as_tensor``, ``load_numpy_state`` and ``program_to_fn`` keep
  an ml_dtypes bfloat16 array bfloat16 (it was widened to float32);
- the small Transformer (2 layers, d_model 32) from bench.py's bf16 state
  cast, 3 Adam steps through each package's ``program_to_fn``, with and
  without flash: every loss within one bf16 ulp of the JAX package's
  (equal to the bit where measured), the state's dtypes the same;
- ``resnet_cifar10`` at depth 8 (batch 8, 32 x 32, bf16 via
  ``dtype``): the softmax within 2**-9 of the JAX package's, the loss
  within one bf16 ulp;
- ResNet-50 at 64 x 64 (batch 4) in bf16: its softmax no farther from
  the JAX package's float32 step (same state, widened) than 1.5 times
  the JAX package's own bf16 step is.  bf16 rounding grows with depth
  and few-sample batch statistics, so the two bf16 steps lie about 0.27
  from the f32 one each, not near each other.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.jax_bridge import init_state as jax_init_state
from paddle_tpu.jax_bridge import program_to_fn as jax_program_to_fn
from paddle_tpu.models import resnet as JR
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.executor import _as_tensor
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.program_fn import program_to_fn as port_program_to_fn

BF16 = ml_dtypes.bfloat16
ELEMENTWISE_ULPS = 1
PRODUCT_ULPS = 2
F32_RTOL = 1e-6
CIFAR_SOFTMAX_ATOL = 2.0 ** -9
RESNET50_RATIO = 1.5


def _bf16(a):
    return np.asarray(a, np.float32).astype(BF16)


def _ulp(x):
    """One bf16 ulp at each |x| (2**-7 of its power of two; the smallest
    normal's spacing at 0)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# one-op Programs
# ---------------------------------------------------------------------------

def _one_op(fl, op_type, inputs, outputs, attrs):
    """A Program of one op: ``inputs`` is ``{slot: (name, array)}`` (each
    declared with its array's shape and dtype and fed), ``outputs``
    ``{slot: name}``."""
    main = fl.Program()
    blk = main.global_block()
    for name, arr in inputs.values():
        blk.create_var(name=name, shape=list(arr.shape),
                       dtype=str(arr.dtype))
    for name in outputs.values():
        blk.create_var(name=name)
    blk.append_op(type=op_type,
                  inputs={s: [n] for s, (n, _) in inputs.items()},
                  outputs={s: [n] for s, n in outputs.items()},
                  attrs=dict(attrs))
    main.random_seed = 7
    return main


def _run_both(op_type, inputs, outputs, attrs):
    """Each output slot as (JAX value, port value), both numpy: bf16 as
    ml_dtypes arrays."""
    feed = {n: a for n, a in inputs.values()}
    names = list(outputs.values())
    jmain = _one_op(jfluid, op_type, inputs, outputs, attrs)
    with jfluid.scope_guard(jfluid.Scope()):
        jout = jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, feed=feed, fetch_list=names)
    tmain = _one_op(tfluid, op_type, inputs, outputs, attrs)
    tout = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=names, scope=tfluid.Scope(),
        return_numpy=False)
    res = {}
    for slot, j, t in zip(outputs, jout, tout):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16).numpy().view(BF16)
        else:
            t = t.numpy()
        res[slot] = (j, t)
    return res


def _kind(dtype):
    name = np.dtype(dtype).name
    if name.startswith(("int", "uint")):
        return "int"
    return name


def _assert_close(slot, want, got, ulps):
    assert _kind(got.dtype) == _kind(want.dtype), (slot, got.dtype,
                                                   want.dtype)
    assert got.shape == want.shape, (slot, got.shape, want.shape)
    if _kind(want.dtype) in ("int", "bool"):
        np.testing.assert_array_equal(got, want, err_msg=slot)
        return
    w = want.astype(np.float64)
    g = got.astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=slot)
    fin = ~np.isnan(w)
    if want.dtype == BF16:
        d = np.abs(g - w)[fin] / _ulp(want)[fin]
        assert d.max(initial=0) <= ulps, (slot, d.max())
    else:
        tol = F32_RTOL * max(np.abs(w[fin]).max(initial=0), 1e-30)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=tol,
                                   err_msg=slot)


def _rand(rng, shape, scale=1.0, lo=None):
    a = rng.randn(*shape) * scale
    if lo is not None:
        a = np.abs(a) + lo
    return _bf16(a)


def _cases():
    rng = np.random.RandomState(0)
    probs = rng.rand(6, 5) + 0.05
    probs /= probs.sum(1, keepdims=True)
    ties = _bf16(np.round(rng.rand(6, 8) * 4) / 4)   # many equal values
    lens = np.array([16, 9], np.int32)
    return {
        # ResNet-50's rules
        "conv2d": ("conv2d", {"Input": _rand(rng, (2, 3, 8, 8)),
                              "Filter": _rand(rng, (4, 3, 3, 3), 0.3)},
                   ["Output"], {"strides": [2, 2], "paddings": [1, 1],
                                "dilations": [1, 1], "groups": 1},
                   PRODUCT_ULPS),
        "batch_norm": ("batch_norm", {
            "X": _rand(rng, (4, 3, 5, 5), 2.0), "Scale": _rand(rng, (3,)),
            "Bias": _rand(rng, (3,)), "Mean": _rand(rng, (3,), 0.1),
            "Variance": _rand(rng, (3,), 0.5, lo=0.5)},
            ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
            {"epsilon": 1e-5, "momentum": 0.9, "is_test": False,
             "data_layout": "NCHW"}, ELEMENTWISE_ULPS),
        "pool2d_max": ("pool2d", {"X": _rand(rng, (2, 3, 9, 9))}, ["Out"],
                       {"pooling_type": "max", "ksize": [3, 3],
                        "strides": [2, 2], "paddings": [1, 1]},
                       ELEMENTWISE_ULPS),
        "pool2d_avg_global": ("pool2d", {"X": _rand(rng, (2, 3, 7, 7))},
                              ["Out"], {"pooling_type": "avg",
                                        "ksize": [7, 7],
                                        "global_pooling": True},
                              ELEMENTWISE_ULPS),
        "relu": ("relu", {"X": _rand(rng, (4, 9))}, ["Out"], {},
                 ELEMENTWISE_ULPS),
        "elementwise_add": ("elementwise_add", {
            "X": _rand(rng, (2, 3, 4, 4)), "Y": _rand(rng, (2, 3, 4, 4))},
            ["Out"], {"axis": -1}, ELEMENTWISE_ULPS),
        "elementwise_add_f32_bias": ("elementwise_add", {
            "X": _rand(rng, (4, 6)),
            "Y": rng.randn(6).astype(np.float32)},
            ["Out"], {"axis": 1}, ELEMENTWISE_ULPS),
        "mul": ("mul", {"X": _rand(rng, (4, 2, 16)),
                        "Y": _rand(rng, (32, 5), 0.2)},
                ["Out"], {"x_num_col_dims": 1, "y_num_col_dims": 1},
                PRODUCT_ULPS),
        "softmax": ("softmax", {"X": _rand(rng, (6, 10), 3.0)}, ["Out"], {},
                    ELEMENTWISE_ULPS),
        "cross_entropy": ("cross_entropy", {
            "X": _bf16(probs),
            "Label": rng.randint(0, 5, (6, 1)).astype(np.int64)},
            ["Y"], {"soft_label": False}, ELEMENTWISE_ULPS),
        "mean": ("mean", {"X": _rand(rng, (8, 16))}, ["Out"], {},
                 ELEMENTWISE_ULPS),
        "top_k": ("top_k", {"X": ties}, ["Out", "Indices"], {"k": 3},
                  ELEMENTWISE_ULPS),
        "accuracy": ("accuracy", {
            "Out": ties[:, :1],
            "Indices": np.argsort(-ties.astype(np.float32), 1,
                                  kind="stable")[:, :1].astype(np.int64),
            "Label": rng.randint(0, 8, (6, 1)).astype(np.int64)},
            ["Accuracy", "Correct", "Total"], {}, ELEMENTWISE_ULPS),
        "momentum": ("momentum", {
            "Param": _rand(rng, (5, 4)), "Grad": _rand(rng, (5, 4)),
            "Velocity": rng.randn(5, 4).astype(np.float32),
            "LearningRate": np.array([0.1], np.float32)},
            ["ParamOut", "VelocityOut"], {"mu": 0.9}, ELEMENTWISE_ULPS),
        # Transformer-base's rules
        "lookup_table": ("lookup_table", {
            "W": _rand(rng, (11, 6)),
            "Ids": rng.randint(0, 11, (4, 3, 1)).astype(np.int64)},
            ["Out"], {"padding_idx": 0}, ELEMENTWISE_ULPS),
        "layer_norm": ("layer_norm", {
            "X": _rand(rng, (2, 5, 8), 3.0), "Scale": _rand(rng, (8,)),
            "Bias": _rand(rng, (8,))}, ["Y", "Mean", "Variance"],
            {"begin_norm_axis": 2, "epsilon": 1e-5}, ELEMENTWISE_ULPS),
        "matmul": ("matmul", {"X": _rand(rng, (2, 3, 5, 8)),
                              "Y": _rand(rng, (2, 3, 7, 8))},
                   ["Out"], {"transpose_Y": True, "alpha": 0.25},
                   PRODUCT_ULPS),
        "flash_attention": ("flash_attention", {
            "Q": _rand(rng, (2, 2, 16, 32)), "K": _rand(rng, (2, 2, 16, 32)),
            "V": _rand(rng, (2, 2, 16, 32)), "KVLens": lens},
            ["Out"], {"causal": True}, PRODUCT_ULPS),
        "softmax_with_cross_entropy": ("softmax_with_cross_entropy", {
            "Logits": _rand(rng, (6, 9), 2.0),
            "Label": rng.randint(0, 9, (6, 1)).astype(np.int64)},
            ["Loss", "Softmax"], {"soft_label": False}, ELEMENTWISE_ULPS),
        "scale": ("scale", {"X": _rand(rng, (4, 7))}, ["Out"],
                  {"scale": 22.627417, "bias": 0.0}, ELEMENTWISE_ULPS),
        "scale_bias": ("scale", {"X": _rand(rng, (4, 7))}, ["Out"],
                       {"scale": 0.5, "bias": 1.0,
                        "bias_after_scale": False}, ELEMENTWISE_ULPS),
        "elementwise_mul": ("elementwise_mul", {
            "X": _rand(rng, (3, 4)), "Y": _rand(rng, (3, 4))}, ["Out"], {},
            ELEMENTWISE_ULPS),
        "elementwise_div": ("elementwise_div", {
            "X": _rand(rng, (3, 4)), "Y": _rand(rng, (3, 4), lo=0.5)},
            ["Out"], {}, ELEMENTWISE_ULPS),
        "elementwise_min": ("elementwise_min", {
            "X": _rand(rng, (3, 4)), "Y": _rand(rng, (3, 4))}, ["Out"], {},
            ELEMENTWISE_ULPS),
        "adam": ("adam", {
            "Param": _rand(rng, (5, 4)), "Grad": _rand(rng, (5, 4), 0.1),
            "Moment1": rng.randn(5, 4).astype(np.float32) * 0.1,
            "Moment2": np.abs(rng.randn(5, 4)).astype(np.float32) * 0.01,
            "LearningRate": np.array([1e-3], np.float32),
            "Beta1Pow": np.array([0.9 ** 3], np.float32),
            "Beta2Pow": np.array([0.98 ** 3], np.float32)},
            ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
             "Beta2PowOut"], {"beta1": 0.9, "beta2": 0.98, "epsilon": 1e-9},
            ELEMENTWISE_ULPS),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_rule_matches_jax_in_bf16(case):
    op_type, arrays, outs, attrs, ulps = CASES[case]
    inputs = {slot: ("in_%s" % slot.lower(), a) for slot, a in arrays.items()}
    outputs = {slot: "out_%s" % slot.lower() for slot in outs}
    for slot, (want, got) in _run_both(op_type, inputs, outputs,
                                       attrs).items():
        _assert_close("%s.%s" % (case, slot), want, got, ulps)


def test_dropout_in_bf16_keeps_dtype_and_values():
    """Dropout draws from each package's own generator: the outputs keep
    the input's dtype, kept values pass unchanged (downgrade_in_infer) and
    dropped ones are 0, in both packages."""
    x = _bf16(np.random.RandomState(1).uniform(1, 2, (64, 64)))
    inputs = {"X": ("x", x)}
    outputs = {"Out": "y", "Mask": "m"}
    res = _run_both("dropout", inputs, outputs, {"dropout_prob": 0.1})
    for want, got in res.values():
        assert got.dtype == want.dtype == BF16
    for out, mask in ((res["Out"][0], res["Mask"][0]),
                      (res["Out"][1], res["Mask"][1])):
        kept = mask.astype(np.float32) == 1
        assert 0.85 < kept.mean() < 0.95
        np.testing.assert_array_equal(out[kept], x[kept])
        assert (out[~kept].astype(np.float32) == 0).all()


# ---------------------------------------------------------------------------
# F-10 and F-11
# ---------------------------------------------------------------------------

def test_layer_norm_takes_bf16_scale_and_bias():
    """ROADMAP F-10: a bfloat16 ``X`` with bfloat16 ``Scale`` and ``Bias``
    (bench.py's bf16 state) raised a mixed-dtype error in ``F.layer_norm``;
    the rule now widens both, as the JAX rule multiplies a float32 product
    by them, and gives the JAX package's ``Y`` in bfloat16."""
    rng = np.random.RandomState(3)
    inputs = {"X": ("x", _rand(rng, (4, 16), 2.0)),
              "Scale": ("s", _rand(rng, (16,))),
              "Bias": ("b", _rand(rng, (16,)))}
    (want, got), = _run_both("layer_norm", inputs, {"Y": "y"},
                             {"begin_norm_axis": 1}).values()
    assert got.dtype == BF16
    _assert_close("layer_norm.Y", want, got, ELEMENTWISE_ULPS)


def test_as_tensor_keeps_bf16():
    """ROADMAP F-11: an ml_dtypes bfloat16 array stays bfloat16, bit for
    bit, when no dtype is asked for; an asked-for dtype still converts."""
    a = _bf16(np.random.RandomState(4).randn(3, 5) * 100)
    t = _as_tensor(a, None, "cpu")
    assert t.dtype == torch.bfloat16
    assert t.view(torch.uint16).numpy().tobytes() == a.view(
        np.uint16).tobytes()
    assert _as_tensor(a[:, ::2], None, "cpu").dtype == torch.bfloat16
    f = _as_tensor(a, torch.float32, "cpu")
    np.testing.assert_array_equal(f.numpy(), a.astype(np.float32))


def test_program_to_fn_and_load_numpy_state_keep_bf16():
    """ROADMAP F-11: ``program_to_fn`` runs a bfloat16 state and feed in
    bfloat16 (it ran them in float32); ``load_numpy_state`` casts to the
    declared dtype, as documented."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.fc(x, size=3, bias_attr=False)
    w = main.global_block().all_parameters()[0]
    rng = np.random.RandomState(5)
    state = {w.name: _bf16(rng.randn(4, 3))}
    fn = port_program_to_fn(main, [y], return_state=True, device="cpu")
    (out,), new_state = fn(state, {"x": _bf16(rng.randn(2, 4))})
    assert out.dtype == torch.bfloat16
    assert new_state[w.name].dtype == torch.bfloat16
    scope = tfluid.Scope()
    tfluid.load_numpy_state(main, state, scope=scope, device="cpu")
    assert scope[w.name].dtype == torch.float32
    np.testing.assert_array_equal(scope[w.name].numpy(),
                                  state[w.name].astype(np.float32))


# ---------------------------------------------------------------------------
# the Transformer from bench.py's bf16 state
# ---------------------------------------------------------------------------

SMALL = dict(batch_size=2, seq_len=16, src_vocab_size=60, trg_vocab_size=60,
             max_length=16, n_layer=2, n_head=2, d_model=32, d_inner=64,
             dropout=0.0)
STEPS = 3


def _token_feeds(seed, vocab=60):
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(STEPS):
        f = {n: rng.randint(3, vocab, size=(2, 16)).astype("int64")
             for n in ("src_word", "trg_word", "lbl_word")}
        f["src_word"][1, 6:] = 0
        f["trg_word"][0, 11:] = 0
        f["lbl_word"][0, 11:] = 0
        feeds.append(f)
    return feeds


def _bench_cast(state):
    """bench.py:383-389: every float32 entry of the state cast to bf16."""
    state = {k: np.asarray(v) for k, v in state.items()}
    return {k: (v.astype(BF16) if v.dtype == np.float32 else v)
            for k, v in state.items()}


@pytest.fixture(scope="module", params=["flash", "plain"])
def transformer_runs(request):
    use_flash = request.param == "flash"
    with jfluid.unique_name.guard():
        jm = JT.get_model(use_flash=use_flash, **SMALL)
    with tfluid.unique_name.guard():
        tm = TT.get_model(use_flash=use_flash, **SMALL)
    state = _bench_cast(jax_init_state(jm["startup"]))
    jfn = jax_program_to_fn(jm["main"], [jm["loss"]], return_state=True)
    tfn = port_program_to_fn(tm["main"], [tm["loss"]], return_state=True,
                             device="cpu")
    js, ts, jl, tl = dict(state), dict(state), [], []
    for f in _token_feeds(1):
        (a,), js = jfn(js, f)
        (b,), ts = tfn(ts, f)
        jl.append(np.asarray(a))
        tl.append(b)
    return {"jax": (jl, js), "port": (tl, ts)}


def test_transformer_bf16_losses_match_jax(transformer_runs):
    jl, _ = transformer_runs["jax"]
    tl, _ = transformer_runs["port"]
    for a, b in zip(jl, tl):
        assert a.dtype == BF16 and b.dtype == torch.bfloat16
    want = np.array([a.astype(np.float64).ravel()[0] for a in jl])
    got = np.array([b.double().ravel()[0].item() for b in tl])
    assert (np.abs(got - want) <= _ulp(want)).all(), (got, want)
    assert len(set(got)) > 1     # the steps moved the parameters


def test_transformer_bf16_state_dtypes_match_jax(transformer_runs):
    """bf16 parameters, float32 accumulators (Adam's moments, as the
    update rules write them), the integer step counters."""
    _, js = transformer_runs["jax"]
    _, ts = transformer_runs["port"]
    assert set(js) == set(ts)
    kinds = set()
    for name in js:
        want = _kind(np.asarray(js[name]).dtype)
        got = _kind(str(ts[name].dtype).replace("torch.", ""))
        assert got == want, (name, got, want)
        kinds.add(want)
    assert {"bfloat16", "float32"} <= kinds


# ---------------------------------------------------------------------------
# ResNet in bf16
# ---------------------------------------------------------------------------

def _resnet_step(fl, R, build, state, feed, dtype):
    """One momentum step of ``build``'s Program from ``state`` (cast to
    ``dtype`` where float): the loss and the softmax, as float64."""
    with fl.unique_name.guard():
        m = build(fl, R, dtype)
    scope = fl.Scope()
    st = {k: (v.astype(np.float32).astype(dtype)
              if np.asarray(v).dtype.kind == "f" or np.asarray(v).dtype == BF16
              else v) for k, v in state.items()}
    data = feed["data"].astype(np.float32).astype(dtype)
    if fl is tfluid:
        tfluid.load_numpy_state(m["main"], st, scope=scope, device="cpu")
        loss, prob = tfluid.Executor(tfluid.CPUPlace()).run(
            m["main"], feed={"data": data, "label": feed["label"]},
            fetch_list=[m["loss"], m["predict"]], scope=scope)
    else:
        for k, v in st.items():
            scope[k] = v
        with jfluid.scope_guard(scope):
            loss, prob = jfluid.Executor(jfluid.CPUPlace()).run(
                m["main"], feed={"data": data, "label": feed["label"]},
                fetch_list=[m["loss"], m["predict"]])
    return (np.asarray(loss).astype(np.float64).ravel()[0],
            np.asarray(prob).astype(np.float64))


def _cifar(fl, R, dtype):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        image = fl.layers.data(name="data", shape=[3, 32, 32],
                               dtype=np.dtype(dtype).name)
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        predict = R.resnet_cifar10(image, 10, depth=8)
        avg_cost = fl.layers.mean(x=fl.layers.cross_entropy(
            input=predict, label=label))
        fl.layers.accuracy(input=predict, label=label)
        fl.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9
                                       ).minimize(avg_cost)
    return {"main": main, "startup": startup, "loss": avg_cost,
            "predict": predict}


def _resnet50(fl, R, dtype):
    return R.get_model(class_dim=10, depth=50, image_shape=(3, 64, 64),
                       lr=0.01, dtype=np.dtype(dtype).name)


def _jax_state(build, seed):
    with jfluid.unique_name.guard():
        m = build(jfluid, JR, BF16)
    m["startup"].random_seed = seed
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(m["startup"])
    return {n: np.asarray(scope[n]) for n in m["main"].persistable_names()
            if n in scope and scope[n] is not None}


def test_resnet_cifar10_depth8_bf16_matches_jax():
    state = _jax_state(_cifar, 5)
    assert any(v.dtype == BF16 for v in state.values())
    rng = np.random.RandomState(7)
    feed = {"data": rng.rand(8, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    jl, jp = _resnet_step(jfluid, JR, _cifar, state, feed, BF16)
    tl, tp = _resnet_step(tfluid, TR, _cifar, state, feed, BF16)
    assert np.abs(tp - jp).max() <= CIFAR_SOFTMAX_ATOL
    assert abs(tl - jl) <= _ulp(np.array([jl]))[0]


def test_resnet50_bf16_no_farther_from_f32_than_jax():
    state = _jax_state(_resnet50, 5)
    rng = np.random.RandomState(7)
    feed = {"data": rng.rand(4, 3, 64, 64).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    l32, p32 = _resnet_step(jfluid, JR, _resnet50, state, feed, np.float32)
    jl, jp = _resnet_step(jfluid, JR, _resnet50, state, feed, BF16)
    tl, tp = _resnet_step(tfluid, TR, _resnet50, state, feed, BF16)
    assert np.isfinite([jl, tl]).all() and np.isfinite(tp).all()
    d_jax = np.abs(jp - p32).max()
    d_port = np.abs(tp - p32).max()
    assert d_port <= RESNET50_RATIO * d_jax, (d_port, d_jax, tl, jl, l32)


def test_resnet_bf16_state_dtypes_match_jax_and_the_program():
    """After a momentum step from one bf16 state, every persistable of the
    depth-8 ResNet holds its Program's declared dtype in both packages:
    bf16 parameters and running statistics, float32 velocities (what
    chip_smoke checks on the card at ResNet-50)."""
    state = _jax_state(_cifar, 5)
    rng = np.random.RandomState(9)
    data = _bf16(rng.rand(4, 3, 32, 32))
    label = rng.randint(0, 10, (4, 1)).astype(np.int64)
    with jfluid.unique_name.guard():
        jm = _cifar(jfluid, JR, BF16)
    with tfluid.unique_name.guard():
        tm = _cifar(tfluid, TR, BF16)
    jscope = jfluid.Scope()
    for k, v in state.items():
        jscope[k] = v
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(
            jm["main"], feed={"data": data, "label": label},
            fetch_list=[jm["loss"]])
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tm["main"], state, scope=tscope, device="cpu")
    tfluid.Executor(tfluid.CPUPlace()).run(
        tm["main"], feed={"data": data, "label": label},
        fetch_list=[tm["loss"]], scope=tscope)
    kinds = set()
    for v in tm["main"].list_vars():
        if not v.persistable or v.name not in state:
            continue
        want = _kind(str(v.dtype))
        assert _kind(np.asarray(jscope[v.name]).dtype) == want, v.name
        assert _kind(str(tscope[v.name].dtype).replace("torch.", "")) \
            == want, v.name
        kinds.add((want, "velocity" in v.name))
    assert ("bfloat16", False) in kinds and ("float32", True) in kinds
