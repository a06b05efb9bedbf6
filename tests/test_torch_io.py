"""The port's io (``paddle_tpu_torch.io``) against the JAX package's, on
the CPU: parameter save/load round trips, and inference-model
directories that load across the packages.

The on-disk format is the JAX package's byte for byte (``__model__`` as
``Program.to_dict()`` JSON, parameters as ``np.save`` / ``np.savez``
files), so a directory saved by either package loads in the other and
predicts the same.  Three models, each at a small size: an MLP (fc 16
relu, fc 4 softmax), MNIST LeNet (``models.mnist``) and the flash
Transformer (``models.transformer.get_model(use_flash=True)``, 2+2
layers, d_model 64, 16 tokens, vocab 500, pruned to its logits; the JAX
package's flash forward runs its Pallas kernel in interpret mode).
Predictions of the two packages agree within 1e-5 relative to the
largest |value| (float32; the packages sum in different orders); the
round trips within one package are exact.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import mnist as JM
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import resilience
from paddle_tpu_torch.models import mnist as TM
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.testing import faults

PREDICT_RTOL = 1e-5
TRANSFORMER = dict(batch_size=2, seq_len=16, src_vocab_size=500,
                   trg_vocab_size=500, max_length=16, n_layer=2, n_head=2,
                   d_model=64, d_inner=128, dropout=0.1, use_flash=True)


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        out = fluid.layers.fc(h, size=4, act="softmax")
    return {"startup": startup, "test": main, "feeds": ["x"],
            "predict": out}


def _lenet(fluid):
    M = JM if fluid is jfluid else TM
    m = M.get_model(batch_size=4)
    return dict(m, feeds=["pixel"])


def _transformer(fluid):
    T = JT if fluid is jfluid else TT
    m = T.get_model(**TRANSFORMER)
    return dict(m, feeds=["src_word", "trg_word"])


MODELS = {"mlp": _mlp, "lenet": _lenet, "transformer": _transformer}


def _feed(name, rows, seed):
    rng = np.random.RandomState(seed)
    if name == "mlp":
        return {"x": rng.randn(rows, 8).astype("float32")}
    if name == "lenet":
        return {"pixel": rng.rand(rows, 1, 28, 28).astype("float32")}
    src = rng.randint(3, 500, size=(rows, 16)).astype("int64")
    trg = rng.randint(3, 500, size=(rows, 16)).astype("int64")
    src[0, 11:] = 0     # pad tails: the flash forward's kv_lens
    trg[-1, 6:] = 0
    return {"src_word": src, "trg_word": trg}


def _save(fluid, name, dirname, seed):
    """Build ``name`` in ``fluid``, run its startup (seeded) and save its
    inference model; returns the pruned Program's fetch names."""
    with fluid.unique_name.guard():
        m = MODELS[name](fluid)
    m["startup"].random_seed = seed
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(m["startup"])
        return fluid.io.save_inference_model(
            dirname, m["feeds"], [m["predict"]], exe,
            main_program=m["test"])


def _predict(fluid, dirname, feed):
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        prog, feed_names, fetch_vars = fluid.io.load_inference_model(
            dirname, exe)
        out = exe.run(prog, feed={n: feed[n] for n in feed_names},
                      fetch_list=fetch_vars)
    return [np.asarray(o) for o in out]


def _close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= PREDICT_RTOL * scale


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{(package, model): dirname}, each saved from its own package's
    seeded startup."""
    root = tmp_path_factory.mktemp("io")
    out = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        for name in MODELS:
            d = str(root / ("%s_%s" % (pkg, name)))
            _save(fluid, name, d, seed=7)
            out[pkg, name] = d
    return out


def _trained_mlp(scope):
    """An MLP with SGD, trained 3 steps in the port on the CPU."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[8], dtype="float32")
        h = tfluid.layers.fc(input=x, size=16, act="relu",
                             param_attr=tfluid.ParamAttr(name="w1"))
        pred = tfluid.layers.fc(input=h, size=1,
                                param_attr=tfluid.ParamAttr(name="w2"))
        cost = tfluid.layers.mean(tfluid.layers.square(pred))
        tfluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": np.random.RandomState(0).randn(32, 8).astype("float32")}
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[cost])
    return main, exe


@pytest.mark.parametrize("filename", [None, "all"])
@pytest.mark.parametrize("which", ["params", "persistables"])
def test_save_load_roundtrip_is_exact(tmp_path, which, filename):
    """save_params / save_persistables, one file per variable or one
    .npz, load back into a fresh scope bit for bit (and the one-file
    layout keeps the JAX package's name, ``all.npz``)."""
    scope = tfluid.Scope()
    main, exe = _trained_mlp(scope)
    save = getattr(tfluid.io, "save_" + which)
    load = getattr(tfluid.io, "load_" + which)
    pred = tfluid.io.is_parameter if which == "params" else \
        tfluid.io.is_persistable
    names = [v.name for v in main.list_vars() if pred(v)]
    assert {"w1", "w2"} <= set(names)
    d = str(tmp_path / "p")
    with tfluid.scope_guard(scope):
        want = {n: tfluid.executor.as_numpy(scope[n]) for n in names}
        save(exe, d, main_program=main, filename=filename)
    if filename:
        assert os.listdir(d) == ["all.npz"]
    else:
        assert sorted(os.listdir(d)) == sorted(n + ".npy" for n in names)
    scope2 = tfluid.Scope()
    with tfluid.scope_guard(scope2):
        load(exe, d, main_program=main, filename=filename)
        for n in names:
            got = np.asarray(scope2[n])
            assert got.dtype == want[n].dtype
            assert got.tobytes() == want[n].tobytes(), n
        w1 = tfluid.io.get_parameter_value_by_name("w1", exe, main)
    assert w1.tobytes() == want["w1"].tobytes()


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_saved_model_predicts_the_same_in_the_port(saved, name):
    d = saved["jax", name]
    feed = _feed(name, 3, seed=1)
    (want,) = _predict(jfluid, d, feed)
    (got,) = _predict(tfluid, d, feed)
    assert np.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_port_saved_model_loads_in_the_jax_package(saved, name):
    d = saved["port", name]
    feed = _feed(name, 2, seed=2)
    (want,) = _predict(tfluid, d, feed)
    (got,) = _predict(jfluid, d, feed)
    _close(got, want)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_json_and_params_layout_equal_between_packages(saved, name):
    """``__model__`` is the same JSON from both packages (the Program,
    its feeds and fetches), and both write the same parameter files."""
    docs = []
    for pkg in ("jax", "port"):
        with open(os.path.join(saved[pkg, name], "__model__")) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    assert sorted(os.listdir(saved["jax", name])) == \
        sorted(os.listdir(saved["port", name]))


def test_inference_model_prunes_the_training_ops(saved):
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        prog, feeds, fetch = tfluid.io.load_inference_model(
            saved["port", "transformer"], exe)
    types = {op.type for op in prog.global_block().ops}
    assert feeds == ["src_word", "trg_word"]
    assert "flash_attention" in types
    assert not types & {"adam", "backward", "one_hot",
                        "softmax_with_cross_entropy"}, types


def test_flaky_model_read_retries_and_a_missing_file_fails(tmp_path):
    d = str(tmp_path / "m")
    _save(tfluid, "mlp", d, seed=3)
    want = _predict(tfluid, d, _feed("mlp", 2, 4))[0]
    retries0 = resilience.retry_count()
    with faults.flaky_io("__model__", times=2, op="read") as fired:
        got = _predict(tfluid, d, _feed("mlp", 2, 4))[0]
    assert fired[0] == 2
    assert resilience.retry_count() >= retries0 + 2
    assert got.tobytes() == want.tobytes()
    # past the retry budget: the injected error, not a half-loaded model
    with faults.flaky_io("__model__", times=50, op="read"):
        with pytest.raises(faults.FaultInjected):
            _predict(tfluid, d, _feed("mlp", 2, 4))
    # a missing parameter file is not transient: no retry, a clean error
    os.remove(os.path.join(d, sorted(f for f in os.listdir(d)
                                     if f.endswith(".npy"))[0]))
    retries1 = resilience.retry_count()
    with pytest.raises(FileNotFoundError):
        _predict(tfluid, d, _feed("mlp", 2, 4))
    assert resilience.retry_count() == retries1
