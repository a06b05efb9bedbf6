"""``paddle_tpu_torch.contrib.mixed_precision`` against the JAX package's,
on the CPU (mirrors ``tests/unittests/test_mixed_precision.py``).

- The rewrite: the MLP's Program after ``decorate(...).minimize`` (and
  the small Transformer's, get_model's body with the optimizer
  decorated) serializes with ``to_string()`` exactly as the JAX package's; the
  parameters stay float32 (the master weights); every forward ``mul``
  reads bfloat16 inputs; a ``cast`` op is inserted.
- Training: 30 SGD steps with a static loss scale of 8 lower the loss
  below 0.8 of the first; dynamic loss scaling is refused.
- Parity: the same startup state and feeds give losses within one bf16
  ulp of the loss (2**-7 of its power of two) of the JAX package's over
  5 steps (the MLP) and over the small Transformer's 3 Adam steps (flash
  and plain).  The losses are float32, but each product's output is
  rounded to bf16 once, and the packages sum the products in different
  orders, so a product may round to the neighbouring bf16 value: the
  losses move by that, not by float32 rounding (measured: the MLP 3e-4
  relative by step 5, the Transformer 1e-4 and 1e-7).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.jax_bridge import init_state as jax_init_state
from paddle_tpu.jax_bridge import program_to_fn as jax_program_to_fn
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.program_fn import program_to_fn as port_program_to_fn

LOSS_ULPS = 1


def _assert_within_bf16_ulps(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
    assert (np.abs(got - want) <= LOSS_ULPS * ulp).all(), (got, want)


def _mlp(fl, scaling=8.0):
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 3
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[8], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        h = fl.layers.fc(input=x, size=16, act="relu")
        p = fl.layers.fc(input=h, size=4, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=p, label=y))
        opt = fl.contrib.mixed_precision.decorate(
            fl.optimizer.SGD(learning_rate=0.2), init_loss_scaling=scaling)
        opt.minimize(loss)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(64, 8).astype("float32"),
            "y": rng.randint(0, 4, size=(64, 1)).astype("int64")}


def test_rewrite_serializes_as_jax():
    jmain, jstartup, _ = _mlp(jfluid)
    tmain, tstartup, _ = _mlp(tfluid)
    assert tmain.to_string() == jmain.to_string()
    assert tstartup.to_string() == jstartup.to_string()


def test_rewrite_keeps_f32_params_and_casts_mul_inputs():
    main, _, _ = _mlp(tfluid)
    blk = main.global_block()
    assert "cast" in [op.type for op in blk.ops]
    for p in blk.all_parameters():
        assert str(p.dtype) == "float32", (p.name, p.dtype)
    muls = [op for op in blk.ops if op.type == "mul"
            and op.attrs.get("op_role") not in ("backward", "optimize")]
    assert muls
    for op in muls:
        for slot in ("X", "Y"):
            assert str(blk.vars[op.inputs[slot][0]].dtype) == "bfloat16"
        assert str(blk.vars[op.outputs["Out"][0]].dtype) == "bfloat16"


def test_bf16_compute_ops_match_jax():
    assert (tfluid.contrib.mixed_precision.BF16_COMPUTE_OPS
            == jfluid.contrib.mixed_precision.BF16_COMPUTE_OPS)


def test_decorated_training_lowers_the_loss():
    main, startup, loss = _mlp(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = _feed()
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        losses = [float(np.ravel(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0])[0])
                  for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_dynamic_loss_scaling_rejected():
    with pytest.raises(NotImplementedError):
        tfluid.contrib.mixed_precision.decorate(
            tfluid.optimizer.SGD(learning_rate=0.1),
            use_dynamic_loss_scaling=True)


def test_decorated_losses_match_jax():
    jmain, jstartup, jloss = _mlp(jfluid)
    tmain, _, tloss = _mlp(tfluid)
    feed = _feed()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        state = {n: np.asarray(jscope[n]) for n in jmain.persistable_names()
                 if n in jscope}
        want = [float(np.ravel(jexe.run(jmain, feed=feed,
                                        fetch_list=[jloss])[0])[0])
                for _ in range(5)]
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tmain, state, scope=tscope, device="cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(np.ravel(texe.run(tmain, feed=feed, fetch_list=[tloss],
                                   scope=tscope)[0])[0]) for _ in range(5)]
    _assert_within_bf16_ulps(got, want)


SMALL = dict(batch_size=2, seq_len=16, src_vocab_size=60, trg_vocab_size=60,
             max_length=16, n_layer=2, n_head=2, d_model=32, d_inner=64,
             dropout=0.0)


def _transformer_bf16(fluid, T, use_flash):
    """Either package's get_model body with its optimizer decorated (the
    JAX package's get_model takes no such argument, nor does the port's)."""
    c = SMALL
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(name=n, shape=[c["seq_len"]],
                                   dtype="int64")
                 for n in ("src_word", "trg_word", "lbl_word")]
        avg_cost, _, _, _ = T.transformer(
            *words, c["src_vocab_size"], c["trg_vocab_size"],
            c["max_length"], c["n_layer"], c["n_head"], c["d_model"],
            c["d_inner"], c["dropout"], use_flash=use_flash)
        main.clone(for_test=True)
        lr = fluid.layers.scale(x=fluid.layers.noam_decay(c["d_model"], 8000),
                                scale=2.0)
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.AdamOptimizer(learning_rate=lr, beta1=0.9,
                                          beta2=0.98, epsilon=1e-9))
        opt.minimize(avg_cost)
    return {"main": main, "startup": startup, "loss": avg_cost}


@pytest.mark.parametrize("use_flash", [True, False])
def test_transformer_decorated_matches_jax(use_flash):
    with jfluid.unique_name.guard():
        jm = _transformer_bf16(jfluid, JT, use_flash)
    with tfluid.unique_name.guard():
        tm = _transformer_bf16(tfluid, TT, use_flash)
    assert tm["main"].to_string() == jm["main"].to_string()
    assert tm["startup"].to_string() == jm["startup"].to_string()
    with tfluid.unique_name.guard():
        f32 = TT.get_model(use_flash=use_flash, **SMALL)
    assert tm["startup"].to_string() == f32["startup"].to_string()
    state = {k: np.asarray(v) for k, v in
             jax_init_state(jm["startup"]).items()}
    rng = np.random.RandomState(1)
    feeds = [{n: rng.randint(3, 60, size=(2, 16)).astype("int64")
              for n in ("src_word", "trg_word", "lbl_word")}
             for _ in range(3)]
    jfn = jax_program_to_fn(jm["main"], [jm["loss"]], return_state=True)
    tfn = port_program_to_fn(tm["main"], [tm["loss"]], return_state=True,
                             device="cpu")
    js, ts, want, got = dict(state), dict(state), [], []
    for f in feeds:
        (a,), js = jfn(js, f)
        (b,), ts = tfn(ts, f)
        want.append(float(np.asarray(a).ravel()[0]))
        got.append(float(b.ravel()[0]))
        assert str(b.dtype) == "torch.float32"
    _assert_within_bf16_ulps(got, want)
    for name, v in ts.items():   # master weights and accumulators stay f32
        assert str(v.dtype) != "torch.bfloat16", name
