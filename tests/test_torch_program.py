"""The port's Fluid Program surface (paddle_tpu_torch) against the JAX
package's, on the CPU: the same layer functions give the same Program, the
startup constants come out bitwise equal, the op rules cover the
Transformer's, the MNIST MLP's and LeNet's Programs (the op-coverage
report prints what is left), and the executor's entry points and
``program_fn`` behave as documented.  Sizes are small (2 layers,
d_model 32)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu.registry import registered_ops as jax_registered_ops
from paddle_tpu_torch.models import mnist as TM
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


def _mlp_programs():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[784], dtype="float32")
        label = tfluid.layers.data(name="label", shape=[1], dtype="int64")
        hidden = tfluid.layers.fc(input=img, size=64, act="relu")
        prediction = tfluid.layers.fc(input=hidden, size=10, act="softmax")
        loss = tfluid.layers.cross_entropy(input=prediction, label=label)
        avg_loss = tfluid.layers.mean(loss)
        tfluid.layers.accuracy(input=prediction, label=label)
        tfluid.optimizer.SGD(learning_rate=0.5).minimize(avg_loss)
    return main, startup, img, avg_loss


#: the control flow's rules beyond what get_inference_model runs
CONTROL_FLOW_OPS = {"conditional_block", "while", "write_to_array",
                    "read_from_array", "lod_array_length", "is_empty",
                    "less_than", "less_equal", "greater_than",
                    "greater_equal", "equal", "not_equal", "logical_and",
                    "logical_or", "logical_xor", "logical_not"}


def test_op_coverage_report():
    """The port's rules are a subset of the JAX package's, and cover every
    op of the MNIST MLP's and LeNet's Programs, of every block of the
    Transformer's beam-search inference Program, and the control flow's;
    the gap left is printed."""
    port, ref = set(registered_ops()), set(jax_registered_ops())
    assert port <= ref, port - ref
    with tfluid.unique_name.guard():
        m = TM.get_model()
    with tfluid.unique_name.guard():
        inf = TT.get_inference_model(beam_size=2, max_out_len=4, seq_len=8,
                                     **{k: SMALL[k] for k in SMALL
                                        if k not in ("batch_size",
                                                     "seq_len")})
    mlp_main, mlp_startup, _, _ = _mlp_programs()
    programs = {"mlp": (mlp_main, mlp_startup),
                "mnist": (m["main"], m["startup"], m["test"]),
                "transformer inference": (inf["infer"], inf["startup"])}
    for name, progs in programs.items():
        needed = {op.type for p in progs for blk in p.blocks
                  for op in blk.ops}
        needed -= {"backward"}
        assert needed <= port, (name, needed - port)
    assert CONTROL_FLOW_OPS <= port, CONTROL_FLOW_OPS - port
    gap = sorted(ref - port)
    print("op coverage: the port registers %d of the reference's %d ops; "
          "%d left: %s" % (len(port), len(ref), len(gap), ", ".join(gap)))
    assert len(port) >= 76


def test_program_fn_matches_the_executor():
    from paddle_tpu_torch import program_fn

    main, startup, img, avg_loss = _mlp_programs()
    x = np.random.RandomState(0).randn(5, 784).astype(np.float32)
    y = np.arange(5).reshape(5, 1)
    state = program_fn.init_state(startup, seed=3, device="cpu")
    assert sorted(state) == sorted(
        n for n in startup.persistable_names() if n in state) and state
    fn = program_fn.program_to_fn(main, [avg_loss], return_state=True,
                                  device="cpu")
    (loss,), new_state = fn(state, {"img": x, "label": y})
    scope = tfluid.Scope()
    tfluid.load_numpy_state(main, {n: v.numpy() for n, v in state.items()},
                            scope=scope, device="cpu")
    (want,) = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"img": x, "label": y}, fetch_list=[avg_loss], scope=scope)
    assert loss.numpy().tobytes() == want.tobytes()
    for n, v in new_state.items():
        if n in scope:
            assert torch.equal(v, scope[n]), n
    assert not torch.equal(new_state["fc_0.w_0"], state["fc_0.w_0"])


@pytest.mark.parametrize("layer", ["py_reader", "double_buffer", "shuffle",
                                   "batch", "open_files"])
def test_reader_layers_raise_naming_what_they_wait_for(layer):
    fn = getattr(tfluid.layers, layer)
    nargs = fn.__code__.co_argcount - len(fn.__defaults__ or ())
    with pytest.raises(NotImplementedError, match="A6"):
        fn(*([None] * nargs))


def test_io_layers_random_data_generator_and_preprocessor():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 2
    with tfluid.program_guard(main, startup):
        src = tfluid.layers.random_data_generator(-2.0, 3.0, [[6, 4]])
        pre = tfluid.layers.Preprocessor(src)
        with pre.block():
            (x,) = pre.inputs()
            pre.outputs(tfluid.layers.scale(x, scale=2.0))
        (y,) = tfluid.layers.read_file(pre())
    xv, yv = tfluid.Executor(tfluid.CPUPlace()).run(
        main, fetch_list=[src.vars[0], y], scope=tfluid.Scope())
    assert xv.shape == (6, 4) and xv.min() >= -2.0 and xv.max() < 3.0
    np.testing.assert_array_equal(yv, xv * 2)


def test_nets_build_the_reference_programs():
    """simple_img_conv_pool, img_conv_group (its batch-norm variant builds
    a batch_norm op, which has no rule yet) and
    scaled_dot_product_attention give the JAX package's Programs; the
    attention also its values."""
    q = np.random.RandomState(1).randn(2, 5, 8).astype(np.float32)
    outs = []
    for fl in (jfluid, tfluid):
        conv, conv_start = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(conv, conv_start):
            img = fl.layers.data(name="img", shape=[3, 12, 12],
                                 dtype="float32")
            fl.nets.simple_img_conv_pool(img, num_filters=4, filter_size=3,
                                         pool_size=2, pool_stride=2,
                                         act="relu")
            fl.nets.img_conv_group(img, conv_num_filter=[4, 4], pool_size=2,
                                   conv_act="relu")
            fl.nets.img_conv_group(img, conv_num_filter=[4], pool_size=2,
                                   conv_with_batchnorm=True)
        att_main, att_start = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(att_main, att_start):
            x = fl.layers.data(name="q", shape=[5, 8], dtype="float32")
            att = fl.nets.scaled_dot_product_attention(x, x, x, num_heads=2)
        (val,) = fl.Executor(fl.CPUPlace()).run(
            att_main, feed={"q": q}, fetch_list=[att], scope=fl.Scope())
        outs.append(([p.to_string() for p in (conv, conv_start, att_main)],
                     val))
    assert outs[0][0] == outs[1][0]
    assert "batch_norm" in outs[1][0][0]
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-5, atol=1e-6)


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
    # nan_guard runs (the step writes the counter, so it has a verdict)
    out, = exe.run(main, feed={"x": np.zeros((2, 3))}, fetch_list=[y],
                   scope=scope, nan_guard=True)
    np.testing.assert_array_equal(out, np.ones((2, 3)))
    assert exe.last_step_ok() is True
