"""``StaticRNN``, ``DynamicRNN`` and the LoD rank-table layers of the
port (``paddle_tpu_torch/layers/control_flow.py``) against the JAX
package's on the CPU, after ``tests/unittests/test_control_flow_op.py``,
``test_control_flow_fixes.py`` and ``test_misc_math_op.py``.

Each case builds the same Program with each package, copies the JAX
startup's parameters into the port and feeds both the same seeded
batch (``test_torch_sequence_ops._run``): the step outputs, the lengths
the outputs carry and the gradients of mean(first output) with respect
to every float feed and parameter, within 2e-5 relative and absolute
(float32 over a recurrence of up to 7 steps), integers exactly.  A
``DynamicRNN`` fed lengths freezes each row's memories past its length
and zeros its outputs there; fed a dense batch it masks nothing, and
its ``static_rnn`` op reads nothing back to the host, so the Program
binds on the fast path and its bound step gives the op-by-op step's
bits.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texe
from test_torch_sequence_ops import Ragged, _ragged, _run

TOL = 2e-5
T, D = 7, 3


def _dense(seed, shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype("float32")


def _elman(fl, rnn, x, h_init=None):
    """h_t = tanh(fc(x_t) + fc(h_{t-1})), its memory from ``h_init`` or
    zeros sized from the step input."""
    L = fl.layers
    with rnn.step() if isinstance(rnn, fl.layers.StaticRNN) else rnn.block():
        xt = rnn.step_input(x)
        if h_init is not None:
            h_prev = rnn.memory(init=h_init)
        elif isinstance(rnn, fl.layers.StaticRNN):
            h_prev = rnn.memory(shape=[-1, D], batch_ref=xt, init_value=0.0)
        else:
            h_prev = rnn.memory(shape=[-1, D], value=0.0)
        wx = L.fc(xt, size=D, param_attr=fl.ParamAttr(name="rnn_w"))
        uh = L.fc(h_prev, size=D, param_attr=fl.ParamAttr(name="rnn_u"),
                  bias_attr=False)
        h = L.tanh(L.elementwise_add(wx, uh))
        rnn.update_memory(h_prev, h)
        rnn.output(h, L.scale(h, scale=2.0))
    return rnn()


@pytest.mark.parametrize("init", [False, True])
def test_static_rnn_matches_jax(init):
    spec = {"x": _dense(1, (2, T, D))}
    if init:
        spec["h0"] = _dense(2, (2, D))
    _run(spec, lambda fl, v: _elman(fl, fl.layers.StaticRNN(), v["x"],
                                    v.get("h0")), tol=TOL)


def test_dynamic_rnn_with_lengths_freezes_rows_past_their_length():
    x = _ragged(3, [7, 2, 5, 0], (D,), T=T)
    got = _run({"x": x}, lambda fl, v: _elman(fl, fl.layers.DynamicRNN(),
                                              v["x"]), lod=[0, 1], tol=TOL)
    out = got[0]
    assert not out[1, 2:].any() and not out[3].any() and out[0].all()
    np.testing.assert_array_equal(got[2], [7, 2, 5, 0])


def test_dynamic_rnn_with_an_initial_memory_and_a_static_input():
    x = _ragged(4, [3, 7, 1], (D,), T=T)

    def body(fl, v):
        L = fl.layers
        rnn = L.DynamicRNN()
        with rnn.block():
            xt = rnn.step_input(v["x"])
            ctx = rnn.static_input(v["ctx"])
            mem = rnn.memory(init=v["h0"])
            h = L.elementwise_add(L.elementwise_mul(mem, xt),
                                  L.fc(ctx, size=D, act="sigmoid"))
            rnn.update_memory(mem, h)
            rnn.output(h)
        return [rnn()]

    _run({"x": x, "ctx": _dense(5, (3, 4)), "h0": _dense(6, (3, D))}, body,
         lod=[0], tol=TOL)


def test_dynamic_rnn_without_lengths_binds_and_replays_its_step():
    """Fed a dense batch, the DynamicRNN masks nothing (the JAX package's
    answer) and its Program binds: one bound entry after two runs, whose
    fetches are the op-by-op step's bits."""
    x = _dense(7, (3, T, D))
    _run({"x": x}, lambda fl, v: _elman(fl, fl.layers.DynamicRNN(), v["x"]),
         tol=TOL)
    main, startup = tfluid.Program(), tfluid.Program()
    startup.random_seed = 3
    with tfluid.program_guard(main, startup):
        xv = tfluid.layers.data(name="x", shape=[T, D], dtype="float32")
        out = _elman(tfluid, tfluid.layers.DynamicRNN(), xv)[0]
        loss = tfluid.layers.mean(out)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    assert texe._graph_refusal(main, {}, [loss.name]) is None
    runs = {}
    for cache in (True, False):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        runs[cache] = [np.asarray(exe.run(main, feed={"x": x},
                                          fetch_list=[loss, out], scope=scope,
                                          use_program_cache=cache)[1])
                       for _ in range(3)]
        if cache:
            assert len([b for b in exe._bound.values() if b.program is main]) == 1
    for a, b in zip(runs[True], runs[False]):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("ragged", [True, False])
def test_max_sequence_len_and_the_rank_table(ragged):
    x = (_ragged(8, [2, 4, 1], (2,), T=5) if ragged
         else _dense(9, (3, 5, 2)))

    def body(fl, v):
        L = fl.layers
        table = L.lod_rank_table(v["x"])
        same = L.reorder_lod_tensor_by_rank(v["x"], table)
        return [L.max_sequence_len(table), L.scale(same, scale=1.0)]

    got = _run({"x": x}, body, grad=False)
    np.testing.assert_array_equal(got[0], [4 if ragged else 5])
    assert got[0].dtype == np.int64
    data = x.data if isinstance(x, Ragged) else x
    np.testing.assert_array_equal(got[1], data)
