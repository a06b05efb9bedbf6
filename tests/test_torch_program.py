"""The port's Fluid Program surface (paddle_tpu_torch) against the JAX
package's, on the CPU: the same layer functions give the same Program, the
startup constants come out bitwise equal, the op rules cover the
Transformer's Programs, and the executor's entry points behave as
documented.  Sizes are small (2 layers, d_model 32)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.registry import registered_ops

SMALL = dict(batch_size=2, seq_len=16, src_vocab_size=60, trg_vocab_size=60,
             max_length=16, n_layer=2, n_head=2, d_model=32, d_inner=64)


def _both(use_flash, **kw):
    args = dict(SMALL, use_flash=use_flash, **kw)
    with jfluid.unique_name.guard():
        jm = JT.get_model(**args)
    with tfluid.unique_name.guard():
        tm = TT.get_model(**args)
    return jm, tm


@pytest.mark.parametrize("use_flash", [True, False])
def test_get_model_programs_serialize_identically(use_flash):
    jm, tm = _both(use_flash)
    for name in ("main", "startup", "test"):
        assert jm[name].to_string() == tm[name].to_string(), name
    assert tm["feeds"] == jm["feeds"]
    assert tm["loss"].name == jm["loss"].name


def test_transformer_graph_serializes_identically():
    progs = []
    for fl, T in ((jfluid, JT), (tfluid, TT)):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            sw = fl.layers.data(name="s", shape=[16], dtype="int64")
            tw = fl.layers.data(name="t", shape=[16], dtype="int64")
            lw = fl.layers.data(name="l", shape=[16], dtype="int64")
            T.transformer(sw, tw, lw, 60, 60, 16, n_layer=1, n_head=2,
                          d_model=32, d_inner=64, dropout=0.1,
                          use_flash=True)
        progs.append((main.to_string(), startup.to_string()))
    assert progs[0] == progs[1]


def test_startup_constants_bitwise_equal_to_jax():
    jm, tm = _both(True)
    const_ops = ("fill_constant", "assign_value")
    names = [op.outputs["Out"][0] for op in tm["startup"].global_block().ops
             if op.type in const_ops]
    assert {"src_pos_enc_table", "causal_bias_table"} <= set(names)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jm["startup"])
    with tfluid.scope_guard(tscope):
        tfluid.Executor(tfluid.CPUPlace()).run(tm["startup"])
    for name in names:
        want = np.asarray(jscope[name])
        got = tscope[name].numpy()
        assert got.shape == want.shape, name
        if np.issubdtype(got.dtype, np.floating):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
        else:  # the JAX package stores int64 as int32 unless x64 is on
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_startup_random_init_is_seeded_and_in_range():
    _, tm = _both(True)
    tm["startup"].random_seed = 5
    vals = []
    for _ in range(2):
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            tfluid.Executor(tfluid.CPUPlace()).run(tm["startup"])
        vals.append(scope["src_word_emb"].clone())
    assert torch.equal(vals[0], vals[1])
    limit = np.sqrt(6.0 / (60 + 32))  # Xavier uniform over [60, 32]
    assert vals[0].abs().max() <= limit and vals[0].std() > limit / 3


@pytest.mark.parametrize("use_flash", [True, False])
def test_op_rules_cover_both_programs(use_flash):
    _, tm = _both(use_flash)
    needed = {op.type for p in ("main", "startup")
              for op in tm[p].global_block().ops} - {"backward"}
    assert needed <= set(registered_ops()), needed - set(registered_ops())


def test_unported_op_raises_naming_it():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.sigmoid(x)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="'sigmoid'"):
        exe.run(main, feed={"x": np.zeros((2, 4), np.float32)},
                fetch_list=[y], scope=tfluid.Scope())


def test_load_numpy_state_checks_names_and_shapes():
    _, tm = _both(True)
    scope = tfluid.Scope()
    w = np.ones((60, 32), np.float32)
    tfluid.load_numpy_state(tm["main"], {"src_word_emb": w}, scope=scope,
                            device="cpu")
    assert scope["src_word_emb"].dtype == torch.float32
    assert scope["src_word_emb"].device.type == "cpu"
    with pytest.raises(KeyError, match="no_such_var"):
        tfluid.load_numpy_state(tm["main"], {"no_such_var": w}, scope=scope,
                                device="cpu")
    with pytest.raises(ValueError, match="src_word_emb"):
        tfluid.load_numpy_state(tm["main"], {"src_word_emb": w[:, :8]},
                                scope=scope, device="cpu")


def test_executor_feed_cast_fetch_and_writeback():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        y = tfluid.layers.scale(x, scale=2.0, bias=1.0)
        counter = tfluid.layers.autoincreased_step_counter(
            counter_name="@C@", begin=1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    assert exe.device == torch.device("cpu")
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for step in range(1, 4):
            out, c = exe.run(main, feed={"x": np.arange(6).reshape(2, 3)},
                             fetch_list=[y, counter])
            assert out.dtype == np.float32 and c.dtype == np.int64
            np.testing.assert_array_equal(out, np.arange(6).reshape(2, 3) * 2 + 1)
            assert int(c[0]) == step and int(scope["@C@"][0]) == step
    with pytest.raises(ValueError, match="feed 'x'"):
        exe.run(main, feed={"x": np.zeros((2, 4))}, scope=scope)
    with pytest.raises(NotImplementedError, match="nan_guard"):
        exe.run(main, feed={"x": np.zeros((2, 3))}, scope=scope,
                nan_guard=True)
