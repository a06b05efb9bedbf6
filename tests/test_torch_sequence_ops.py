"""The sequence and recurrence op rules of the port
(``paddle_tpu_torch/ops/sequence_ops.py``, all 21) against the JAX
package's on the CPU, one parametrised case an op or an edge of it,
after ``tests/unittests/test_sequence_*.py``,
``test_dynamic_lstm_gru_op.py`` and ``test_gru_lstm_unit_op.py``.

Each case builds the same Program with each package through the layer
functions of ``layers/sequence.py`` (``sequence_pool`` through its
``MaxIndex`` where a case fetches it), copies the JAX startup's
parameters into the port (``test_torch_ops._pair``) and feeds both the
same seeded ragged batches: padded data whose padding holds random
values (not zeros), so that a rule that reads past a length shows, and
int32 lengths, a zero length among them where the op takes one.  It
compares every output, each output's ``@LENGTHS`` (and
``@SUBLENGTHS``) exactly, and the gradients of mean(first output) with
respect to every float feed and parameter: float32 within 1e-5
relative and absolute (a recurrence over 8 steps: 2e-5), integers
exactly.

Traps of a line-by-line port, each a case:
- ``MAX`` pooling shares a tied gradient equally (``jnp.max``), and its
  ``MaxIndex`` is the first maximum;
- ``is_reverse`` reverses each row within its own length, the padding
  left where it is; the peepholes sit in ``Bias[4D:7D]``, the LSTM's
  gate columns are {c, i, f, o}, ``lstm_unit``'s {i, f, o, g} and the
  GRU's {update, reset, candidate} with ``origin_mode`` swapping u;
- ``sequence_scatter`` wraps an id in [-N, 0) and drops one outside
  [-N, N) (``.at[].add(mode="drop")``); ``sequence_slice`` clamps its
  window to the row; ``sequence_erase`` compacts what it keeps;
- ``sequence_expand`` at ``ref_level=0`` against a nested ``y`` repeats
  x's rows by ``y@SUBLENGTHS``.

``sequence_mask`` without a ``maxlen`` reads its width back to the host
(``reads_host`` for that use only); the JAX package cannot run it under
its traced step, so its cases hold the port to numpy.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import lod as JL
from paddle_tpu_torch import executor as texe, lod as TL, registry as treg
from test_torch_ops import _pair

TOL = 1e-5
RNN_TOL = 2e-5
_LOD = {id(jfluid): JL, id(tfluid): TL}


class Ragged:
    """A ragged feed: padded ``data`` [B, T, ...], ``lengths`` [B] and,
    for a nested feed, ``sub`` [groups]."""

    def __init__(self, data, lengths, sub=None):
        self.data = data
        self.lengths = np.asarray(lengths, np.int32)
        self.sub = None if sub is None else np.asarray(sub, np.int32)


def _ragged(seed, lengths, tail=(), T=None, ints=None, sub=None):
    r = np.random.RandomState(seed)
    shape = (len(lengths), T or max(lengths)) + tuple(tail)
    data = (r.randint(*ints, size=shape).astype("int64") if ints
            else r.uniform(-2, 2, shape).astype("float32"))
    return Ragged(data, lengths, sub)


def _feed(spec):
    def make(fl):
        lod = _LOD[id(fl)]
        return {n: (lod.LoDArray(v.data, v.lengths, v.sub)
                    if isinstance(v, Ragged) else v) for n, v in spec.items()}
    return make


def _run(spec, body, lod=(), sub=(), grad=True, tol=TOL, extra=()):
    """``body(fl, vars)`` -> its outputs, over data variables named as
    ``spec``; fetches the outputs, the names in ``extra(fl, main)``, the
    ``@LENGTHS`` of the outputs indexed in ``lod`` (``@SUBLENGTHS`` of
    those in ``sub``) and the gradients of mean(first output) with
    respect to every float feed and parameter.  Compares the two
    packages and returns the port's fetches."""
    def build(fl):
        vs = {}
        for n, v in spec.items():
            a = v.data if isinstance(v, Ragged) else v
            if isinstance(v, Ragged):
                vs[n] = fl.layers.data(
                    name=n, shape=list(a.shape[2:]), dtype=str(a.dtype),
                    lod_level=1 if v.sub is None else 2,
                    stop_gradient=a.dtype.kind != "f")
            else:
                vs[n] = fl.layers.data(
                    name=n, shape=list(a.shape), dtype=str(a.dtype),
                    append_batch_size=False, stop_gradient=a.dtype.kind != "f")
        outs = list(body(fl, vs))
        main = fl.default_main_program()
        fetch = outs + list(extra(fl, main) if extra else [])
        fetch += [outs[i].name + "@LENGTHS" for i in lod]
        fetch += [outs[i].name + "@SUBLENGTHS" for i in sub]
        wrt = [vs[n] for n, v in spec.items()
               if (v.data if isinstance(v, Ragged) else v).dtype.kind == "f"]
        wrt += main.global_block().all_parameters()
        if grad and wrt and outs[0].dtype in ("float32", "float64"):
            fetch += fl.backward.calc_gradient(fl.layers.mean(outs[0]), wrt)
        return fetch

    want, got = _pair(build, _feed(spec))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
        else:
            assert g.dtype == w.dtype or (w.dtype == np.int32
                                          and g.dtype == np.int64), (g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w)
    return got


LENS = [5, 2, 0, 4]
SEQ = _ragged(1, LENS, (3,), T=6)

# ---------------------------------------------------------------------------
# pooling, softmax, conv over time (test_sequence_conv_pool_op.py,
# test_sequence_ops.py, test_sequence_pad_slice_op.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["average", "sum", "sqrt", "max", "min",
                                  "last", "first"])
def test_sequence_pool_matches_jax(pool):
    # MAX and MIN over an empty row give the dtype's extreme, whose mean
    # overflows: those cases take rows of length >= 1
    x = _ragged(2, [5, 2, 1, 4], (3,), T=6) if pool in ("max", "min") else SEQ
    _run({"x": x}, lambda fl, v: [fl.layers.sequence_pool(v["x"], pool)])


def test_sequence_pool_max_shares_ties_and_indexes_the_first():
    data = np.array([[[1.0, 3.0], [3.0, 3.0], [3.0, 9.0]],
                     [[2.0, 0.0], [2.0, 5.0], [7.0, 5.0]]], "float32")
    x = Ragged(data, [3, 2])

    def max_index(fl, main):
        return [main.global_block().ops[-1].outputs["MaxIndex"][0]]

    got = _run({"x": x}, lambda fl, v: [fl.layers.sequence_pool(v["x"], "max")],
               extra=max_index)
    np.testing.assert_array_equal(got[0], [[3, 9], [2, 5]])
    np.testing.assert_array_equal(got[1], [[1, 2], [0, 1]])
    # d mean / d x: 1/4 a maximum, split among the tied ones
    np.testing.assert_array_equal(got[2][0], [[0, 0], [0.125, 0], [0.125, 0.25]])
    np.testing.assert_array_equal(got[2][1], [[0.125, 0], [0.125, 0.25], [0, 0]])


@pytest.mark.parametrize("squeeze", [False, True])
def test_sequence_softmax_matches_jax(squeeze):
    """Each row's probabilities sum to 1, so mean(softmax) has no
    gradient: the gradient is taken of the probabilities weighed by a
    feed."""
    x = _ragged(3, [6, 1, 3], (1,) if squeeze else (), T=6)
    w = np.random.RandomState(4).uniform(-2, 2, x.data.shape).astype("float32")

    def body(fl, v):
        probs = fl.layers.sequence_softmax(v["x"])
        return [fl.layers.elementwise_mul(probs, v["w"]), probs]

    got = _run({"x": x, "w": w}, body, lod=[1])
    probs = got[1].reshape(3, 6)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-6)
    assert not probs[1, 1:].any()


@pytest.mark.parametrize("filter_size", [3, 4, 1])
def test_sequence_conv_matches_jax(filter_size):
    _run({"x": _ragged(4, [6, 3, 1], (4,), T=7)},
         lambda fl, v: [fl.layers.sequence_conv(v["x"], num_filters=5,
                                                filter_size=filter_size,
                                                act="tanh")], lod=[0])


def test_row_conv_matches_jax():
    _run({"x": _ragged(5, [5, 3, 6], (4,), T=6)},
         lambda fl, v: [fl.layers.row_conv(v["x"], future_context_size=2)],
         lod=[0])


# ---------------------------------------------------------------------------
# structure ops (test_sequence_expand_scatter_op.py, test_sequence_misc_op.py,
# test_sequence_pad_slice_op.py)
# ---------------------------------------------------------------------------


def test_sequence_expand_broadcasts_a_row_over_y():
    x = np.random.RandomState(6).uniform(-2, 2, (4, 3)).astype("float32")
    _run({"x": x, "y": _ragged(7, LENS, (2,), T=6)},
         lambda fl, v: [fl.layers.sequence_expand(v["x"], v["y"])], lod=[0])


def test_sequence_expand_remasks_a_sequence_to_y():
    _run({"x": _ragged(8, [3, 3, 2, 1], (3,), T=4),
          "y": _ragged(9, [2, 6, 1, 3], (2,), T=6)},
         lambda fl, v: [fl.layers.sequence_expand(v["x"], v["y"])], lod=[0])


def test_sequence_expand_as_matches_jax():
    x = np.random.RandomState(10).uniform(-2, 2, (3, 1, 4)).astype("float32")
    _run({"x": x, "y": _ragged(11, [2, 5, 3], (1,))},
         lambda fl, v: [fl.layers.sequence_expand_as(v["x"], v["y"])], lod=[0])


def test_sequence_expand_ref_level0_repeats_rows_by_sub_lengths():
    x = _ragged(12, [2, 4], (3,), T=4)
    y = _ragged(13, [1, 3, 2, 2, 1], (1,), T=3, sub=[3, 2])
    got = _run({"x": x, "y": y},
               lambda fl, v: [fl.layers.sequence_expand(v["x"], v["y"],
                                                        ref_level=0)],
               lod=[0], sub=[0])
    np.testing.assert_array_equal(got[1], [2, 2, 2, 4, 4])
    np.testing.assert_array_equal(got[2], [3, 2])


def test_sequence_concat_compacts_the_valid_prefixes():
    got = _run({"a": _ragged(14, [2, 0, 3], (3,), T=4),
                "b": _ragged(15, [1, 4, 2], (3,), T=4)},
               lambda fl, v: [fl.layers.sequence_concat([v["a"], v["b"]])],
               lod=[0])
    np.testing.assert_array_equal(got[1], [3, 4, 5])


@pytest.mark.parametrize("new_dim", [2, 8])
def test_sequence_reshape_matches_jax(new_dim):
    _run({"x": _ragged(16, [4, 2, 3], (4,), T=4)},
         lambda fl, v: [fl.layers.sequence_reshape(v["x"], new_dim)], lod=[0])


@pytest.mark.parametrize("tail", [(), (1,)])
def test_sequence_enumerate_matches_jax(tail):
    ids = _ragged(17, [5, 2, 3], tail, T=5, ints=(1, 9))
    _run({"ids": ids},
         lambda fl, v: [fl.layers.sequence_enumerate(v["ids"], win_size=3,
                                                     pad_value=-1)], lod=[0])


def test_sequence_scatter_wraps_negative_and_drops_out_of_range_ids():
    x = np.random.RandomState(18).uniform(-2, 2, (3, 6)).astype("float32")
    ids = Ragged(np.array([[0, 5, -1, 2], [3, 3, 9, -7], [1, 4, 4, 0]],
                          "int64"), [4, 4, 2])
    upd = Ragged(np.random.RandomState(19).uniform(-2, 2, (3, 4))
                 .astype("float32"), [4, 4, 2])
    got = _run({"x": x, "ids": ids, "upd": upd},
               lambda fl, v: [fl.layers.sequence_scatter(v["x"], v["ids"],
                                                         v["upd"])])
    want = x.copy()
    for b in range(3):
        for j in range(ids.lengths[b]):
            i = int(ids.data[b, j])
            if -6 <= i < 6:
                want[b, i % 6] += upd.data[b, j]
    np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)


def test_sequence_slice_clamps_its_window():
    off = np.array([[1], [0], [3]], "int64")
    length = np.array([[2], [3], [3]], "int64")
    _run({"x": _ragged(20, [4, 3, 5], (2,), T=5), "off": off, "len": length},
         lambda fl, v: [fl.layers.sequence_slice(v["x"], v["off"], v["len"])],
         lod=[0])


@pytest.mark.parametrize("maxlen", [None, 8, 3])
def test_sequence_pad_matches_jax(maxlen):
    def body(fl, v):
        return fl.layers.sequence_pad(v["x"], pad_value=-1.5, maxlen=maxlen)

    _run({"x": _ragged(21, LENS, (2,), T=6)}, body)


def test_sequence_unpad_matches_jax():
    x = np.random.RandomState(22).uniform(-2, 2, (3, 5, 2)).astype("float32")
    length = np.array([5, 1, 3], "int64")
    _run({"x": x, "len": length},
         lambda fl, v: [fl.layers.sequence_unpad(v["x"], v["len"])], lod=[0])


@pytest.mark.parametrize("dtype", ["int64", "float32", "bool"])
def test_sequence_mask_matches_jax(dtype):
    x = np.array([3, 0, 5, 1], "int64")
    got = _run({"x": x}, lambda fl, v: [fl.layers.sequence_mask(
        v["x"], maxlen=6, dtype=dtype)], grad=False)
    np.testing.assert_array_equal(got[0], np.arange(6)[None] < x[:, None])


@pytest.mark.parametrize("width", ["data", "tensor"])
def test_sequence_mask_without_maxlen_reads_the_host(width):
    """Without ``maxlen`` the width is the longest length (or
    ``MaxLenTensor``): the op is ``reads_host``, its Program is refused
    by the fast path, and the mask is numpy's."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="int64",
                               append_batch_size=False)
        maxlen = None
        if width == "tensor":
            maxlen = tfluid.layers.fill_constant([1], "int64", 7)
        mask = tfluid.layers.sequence_mask(x, maxlen=maxlen)
    (op,) = [o for o in main.global_block().ops if o.type == "sequence_mask"]
    assert treg.reads_host(op) and texe._graph_refusal(main, {}, []) == "sequence_mask"
    lens = np.array([3, 0, 5, 1], "int64")
    (got,) = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": lens}, fetch_list=[mask], scope=tfluid.Scope())
    n = 7 if width == "tensor" else 5
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.arange(n)[None] < lens[:, None])


@pytest.mark.parametrize("tail", [(), (1,)])
def test_sequence_erase_compacts_what_it_keeps(tail):
    ids = Ragged(np.array([[2, 5, 3, 2, 7, 1], [5, 5, 6, 2, 9, 9],
                           [4, 2, 2, 2, 2, 2]], "int64").reshape((3, 6) + tail),
                 [6, 4, 2])
    got = _run({"ids": ids},
               lambda fl, v: [fl.layers.sequence_erase(v["ids"], tokens=[2, 5])],
               lod=[0])
    np.testing.assert_array_equal(got[0].reshape(3, 6)[0, :3], [3, 7, 1])
    np.testing.assert_array_equal(got[1], [3, 1, 1])


@pytest.mark.parametrize("case", ["target_lod", "dense_target_lod", "y",
                                  "y_offsets"])
def test_lod_reset_repacks_the_payload(case):
    x = _ragged(23, [2, 3, 1], (2,), T=3)
    spec = {"x": x}
    if case == "dense_target_lod":
        spec = {"x": np.random.RandomState(24).uniform(-2, 2, (6, 2))
                .astype("float32")}
    if case == "y":
        spec["y"] = _ragged(25, [1, 4, 1], (1,), T=4)
    if case == "y_offsets":
        spec["y"] = np.array([0, 4, 6], "int32")

    def body(fl, v):
        if case.startswith("y"):
            return [fl.layers.lod_reset(v["x"], y=v["y"])]
        return [fl.layers.lod_reset(v["x"], target_lod=[0, 4, 5, 6])]

    _run(spec, body, lod=[0])


# ---------------------------------------------------------------------------
# recurrences (test_dynamic_lstm_gru_op.py, test_gru_lstm_unit_op.py)
# ---------------------------------------------------------------------------

D = 4
RNN_LENS = [8, 3, 0, 6]

#: dynamic_lstm cases: (peepholes, is_reverse, h0 and c0, activations)
LSTMS = {
    "peepholes": (True, False, False, {}),
    "no peepholes": (False, False, False, {}),
    "reverse": (True, True, False, {}),
    "initial state": (False, False, True, {}),
    "activations": (True, True, True, {"gate_activation": "tanh",
                                       "cell_activation": "relu",
                                       "candidate_activation": "identity"}),
}


@pytest.mark.parametrize("case", list(LSTMS))
def test_dynamic_lstm_matches_jax(case):
    peep, rev, init, acts = LSTMS[case]
    spec = {"x": _ragged(30, RNN_LENS, (4 * D,))}
    if init:
        for i, n in enumerate(("h0", "c0")):
            spec[n] = np.random.RandomState(31 + i).uniform(
                -1, 1, (4, D)).astype("float32")

    def body(fl, v):
        h, c = fl.layers.dynamic_lstm(
            v["x"], size=4 * D, use_peepholes=peep, is_reverse=rev,
            h_0=v.get("h0"), c_0=v.get("c0"), **acts)
        return [h, c]

    got = _run(spec, body, lod=[0, 1], tol=RNN_TOL)
    assert not got[0][2].any() and not got[0][1, 3:].any()


@pytest.mark.parametrize("peep,rev", [(True, False), (False, True)])
def test_dynamic_lstmp_matches_jax(peep, rev):
    _run({"x": _ragged(32, RNN_LENS, (4 * D,))},
         lambda fl, v: list(fl.layers.dynamic_lstmp(
             v["x"], size=4 * D, proj_size=3, use_peepholes=peep,
             is_reverse=rev)), lod=[0], tol=RNN_TOL)


@pytest.mark.parametrize("origin,rev,init", [(False, False, False),
                                             (True, False, True),
                                             (False, True, False)])
def test_dynamic_gru_matches_jax(origin, rev, init):
    spec = {"x": _ragged(33, RNN_LENS, (3 * D,))}
    if init:
        spec["h0"] = np.random.RandomState(34).uniform(
            -1, 1, (4, D)).astype("float32")
    _run(spec, lambda fl, v: [fl.layers.dynamic_gru(
        v["x"], size=D, is_reverse=rev, origin_mode=origin, h_0=v.get("h0"))],
        lod=[0], tol=RNN_TOL)


@pytest.mark.parametrize("origin,bias", [(False, True), (True, False)])
def test_gru_unit_matches_jax(origin, bias):
    r = np.random.RandomState(35)
    spec = {"x": r.uniform(-1, 1, (3, 3 * D)).astype("float32"),
            "h": r.uniform(-1, 1, (3, D)).astype("float32")}
    _run(spec, lambda fl, v: list(fl.layers.gru_unit(
        v["x"], v["h"], size=3 * D, origin_mode=origin,
        bias_attr=None if bias else False)))


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_matches_jax(forget_bias):
    r = np.random.RandomState(36)
    spec = {"x": r.uniform(-1, 1, (3, 5)).astype("float32"),
            "h": r.uniform(-1, 1, (3, D)).astype("float32"),
            "c": r.uniform(-1, 1, (3, D)).astype("float32")}
    _run(spec, lambda fl, v: list(fl.layers.lstm_unit(
        v["x"], v["h"], v["c"], forget_bias=forget_bias)))


def test_every_sequence_rule_is_ported():
    """The port registers every rule of the JAX package's
    ``ops/sequence_ops.py``."""
    from paddle_tpu.ops import sequence_ops as JSO
    import paddle_tpu_torch.ops.sequence_ops as TSO

    def names(module, registry):
        return {t for t, fn in registry.RULES.items()
                if fn.__module__ == module.__name__}

    from paddle_tpu import registry as jreg
    want = names(JSO, jreg)
    assert len(want) == 21 and want == names(TSO, treg)


#: the reference's op names the port has no rule for, by the module that
#: registers them: none since the quantize ops came
STILL_MISSING = {}


def test_op_and_layer_coverage():
    """With every ``ops`` module of both packages imported, the port
    registers all 221 of the reference's op names, and no other.  Its
    ``layers.__all__`` has every name of the reference's, ``Pipeline``
    and the 15 detection layers among them, and ``layers.get_places`` as
    the reference has it."""
    import importlib
    import pkgutil

    import paddle_tpu.contrib.quantize  # noqa: F401
    import paddle_tpu.ops as jops
    import paddle_tpu_torch.ops as tops
    from paddle_tpu import registry as jreg

    for pkg in (jops, tops):
        for mod in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(pkg.__name__ + "." + mod.name)
    want, got = set(jreg.RULES), set(treg.RULES)
    assert len(want) == 221 and got == want and len(got) == 221
    assert sorted(want - got) == sorted(
        n for names in STILL_MISSING.values() for n in names) == []
    lacking = set(jfluid.layers.__all__) - set(tfluid.layers.__all__)
    assert lacking == set()
    assert "Pipeline" in tfluid.layers.__all__
    assert callable(tfluid.layers.get_places) and callable(jfluid.layers.get_places)
    assert tfluid.layers.detection.__all__ == jfluid.layers.detection.__all__
    assert len(tfluid.layers.detection.__all__) == 15


def test_top_level_names_lack_only_the_data_path():
    """The port's top-level ``__all__`` has every name of the reference's
    but ``dataset`` and ``recordio_writer`` (ROADMAP A12.2, A12.3) and
    ``TPUPlace`` (kept out: the port has no TPU)."""
    lacking = set(jfluid.__all__) - set(tfluid.__all__)
    assert lacking == {"dataset", "recordio_writer", "TPUPlace"}
    for name in ("metrics", "average", "debugger", "contrib", "Evaluator",
                 "LoDTensor", "CUDAPinnedPlace"):
        assert hasattr(tfluid, name), name
    assert tfluid.LoDTensor is tfluid.LoDArray
    assert isinstance(tfluid.CUDAPinnedPlace(), tfluid.CPUPlace)
    assert tfluid.executor.enable_compilation_cache() is False
