"""``lod`` and ``DataFeeder`` of the port against the JAX package's, on
the CPU: the same inputs give the same padded arrays, lengths, nested
lengths and offset LoD (exactly); the feeder's dense slots come out as
tensors on its place with the reference's values; and the port's
Executor takes a ragged feed as its data plus ``<name>@LENGTHS``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import lod as JL
from paddle_tpu_torch import lod as TL


def _same_lod(got, want):
    assert type(got).__name__ == "LoDArray"
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert (got.sub_lengths is None) == (want.sub_lengths is None)
    if want.sub_lengths is not None:
        np.testing.assert_array_equal(got.sub_lengths, want.sub_lengths)
    assert got.lod() == want.lod()
    assert got.recursive_sequence_lengths() == want.recursive_sequence_lengths()
    assert got.lod_level == want.lod_level
    assert got.has_valid_recursive_sequence_lengths() == \
        want.has_valid_recursive_sequence_lengths()


_SEQS = [np.arange(3, dtype="int64"), np.arange(5, dtype="int64") + 10,
         np.array([7], "int64")]
_FLAT = np.arange(12, dtype="float32").reshape(6, 2)

#: create_lod_tensor inputs: (data, recursive_seq_lens)
CREATE_CASES = {
    "list": (_SEQS, None),
    "flat_one_level": (_FLAT, [[2, 3, 1]]),
    "flat_nested": (_FLAT, [[2, 1], [1, 3, 2]]),
    "list_of_groups": ([[np.ones((2, 2)), np.zeros((1, 2))], [np.ones((3, 2))]],
                       None),
    "scalar_lists_are_one_level": ([[1, 2, 3], [4, 5]], None),
    "dense": (_FLAT, None),
}


@pytest.mark.parametrize("case", list(CREATE_CASES))
def test_create_lod_tensor_matches_jax(case):
    data, lens = CREATE_CASES[case]
    _same_lod(TL.create_lod_tensor(data, lens), JL.create_lod_tensor(data, lens))


#: F-19: the top-level ``create_lod_tensor`` takes its lengths as
#: optional, as the reference's does (it is ``create_lod_array``)
TOP_LEVEL_CASES = {
    "list_of_sequences": [np.arange(3).reshape(3, 1),
                          np.arange(2).reshape(2, 1)],
    "list_of_groups": [[np.ones((2, 2)), np.zeros((1, 2))],
                       [np.ones((3, 2))]],
}


@pytest.mark.parametrize("case", list(TOP_LEVEL_CASES))
def test_top_level_create_lod_tensor_takes_optional_lengths_f19(case):
    data = TOP_LEVEL_CASES[case]
    got = tfluid.create_lod_tensor(data)
    _same_lod(got, jfluid.create_lod_tensor(data))
    assert tfluid.create_lod_tensor is tfluid.create_lod_array
    if case == "list_of_sequences":
        assert got.data.shape == (2, 3, 1)
        np.testing.assert_array_equal(got.lengths, [3, 2])


def test_pack_unpack_and_lod_methods_match_jax():
    for kw in ({}, {"maxlen": 4, "pad_value": -1}):
        got = TL.pack_sequences(_SEQS, **kw)
        want = JL.pack_sequences(_SEQS, **kw)
        _same_lod(got, want)
        for g, w in zip(TL.unpack_sequences(got), JL.unpack_sequences(want)):
            np.testing.assert_array_equal(g, w)
    got, want = TL.pack_sequences(_SEQS), JL.pack_sequences(_SEQS)
    got.set_lod([[0, 2, 3], [0, 1, 4, 6]])
    want.set_lod([[0, 2, 3], [0, 1, 4, 6]])
    _same_lod(got, want)
    with pytest.raises(ValueError, match="2 LoD levels"):
        got.set_recursive_sequence_lengths([[1], [1], [1]])
    with pytest.raises(ValueError, match="inconsistent"):
        TL.create_lod_tensor(_FLAT, [[2, 2], [1, 3, 2]])
    arr = TL.LoDTensorArray()
    assert arr.append(got) is arr and len(arr) == 1


@pytest.mark.parametrize("lens", [[[2, 0, 4]], [[1, 2], [3, 1, 2]]])
def test_create_random_int_lodtensor_matches_jax(lens):
    np.random.seed(3)
    want = JL.create_random_int_lodtensor(lens, [2], low=1, high=6)
    np.random.seed(3)
    got = TL.create_random_int_lodtensor(lens, [2], low=1, high=6)
    _same_lod(got, want)


def _feeder_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        img = fl.layers.data(name="pixel", shape=[1, 4, 4], dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        words = fl.layers.data(name="words", shape=[1], dtype="int64",
                               lod_level=1)
        paras = fl.layers.data(name="paras", shape=[1], dtype="int64",
                               lod_level=2)
    return main, [img, label, words, paras]


def test_data_feeder_matches_jax():
    rng = np.random.RandomState(0)
    batch = [(rng.rand(16).astype("float32"), int(rng.randint(10)),
              list(rng.randint(0, 9, size=n)),
              [list(rng.randint(0, 9, size=m)) for m in (1, n)])
             for n in (3, 1, 4)]
    jmain, jvars = _feeder_program(jfluid)
    tmain, tvars = _feeder_program(tfluid)
    want = jfluid.DataFeeder(jvars, jfluid.CPUPlace(), program=jmain).feed(batch)
    got = tfluid.DataFeeder(tvars, tfluid.CPUPlace(), program=tmain).feed(batch)
    assert sorted(got) == sorted(want)
    for name in ("pixel", "label"):
        assert isinstance(got[name], torch.Tensor)
        assert got[name].device.type == "cpu"
        np.testing.assert_array_equal(got[name].numpy(), want[name])
        assert got[name].numpy().dtype == want[name].dtype
    assert got["pixel"].shape == (3, 1, 4, 4)
    for name in ("words", "paras"):
        _same_lod(got[name], want[name])
    by_name = tfluid.DataFeeder(["pixel", "label"], tfluid.CPUPlace(),
                                program=tmain)
    halves = list(by_name.feed_parallel([b[:2] for b in batch[:2]], 2))
    assert [h["label"].shape for h in halves] == [(1, 1), (1, 1)]
    with pytest.raises(ValueError, match="slots"):
        by_name.feed([batch[0]])
    reader = lambda: iter([[b[:2] for b in batch[:2]]] * 2)  # noqa: E731
    plain = list(by_name.decorate_reader(reader, multi_devices=False)())
    split = list(by_name.decorate_reader(reader, multi_devices=True,
                                         num_places=2)())
    assert len(plain) == len(split) == 2
    assert plain[0]["label"].shape == (2, 1)
    assert [len(s) for s in split] == [2, 2]
    assert torch.equal(torch.cat([d["label"] for d in split[0]]),
                       plain[0]["label"])


def test_executor_takes_a_ragged_feed():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        words = tfluid.layers.data(name="words", shape=[1], dtype="int64",
                                   lod_level=2)
        out = tfluid.layers.scale(tfluid.layers.cast(words, "float32"),
                                  scale=2.0)
    feed = tfluid.create_lod_tensor([[np.array([[1], [2]]), np.array([[3]])],
                                     [np.array([[4], [5], [6]])]], None)
    (got, lens, sub) = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"words": feed},
        fetch_list=[out, "words@LENGTHS", "words@SUBLENGTHS"],
        scope=tfluid.Scope())
    np.testing.assert_array_equal(got, feed.data * 2)
    assert lens.dtype == sub.dtype == np.int32
    np.testing.assert_array_equal(lens, [2, 1, 3])
    np.testing.assert_array_equal(sub, [2, 1])


def _lod_fetch_program(fl):
    """Five ops over a ragged ``words`` feed, each of whose rules carries
    the input's lengths to its output: embedding and dropout (training)
    of int64 words, scale, cast and relu of float32 words."""
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = main.random_seed = 7
    with fl.program_guard(main, startup):
        ids = fl.layers.data(name="ids", shape=[1], dtype="int64",
                             lod_level=1)
        words = fl.layers.data(name="words", shape=[1], dtype="float32",
                               lod_level=1)
        emb = fl.layers.embedding(ids, size=[10, 4])
        outs = [emb, fl.layers.dropout(emb, 0.5),
                fl.layers.scale(words, scale=2.0),
                fl.layers.cast(words, "float64"),
                fl.layers.relu(words)]
    return main, startup, outs


def test_length_carrying_rules_keep_the_lod():
    """F-16: embedding, dropout, scale, cast and relu fetched with
    ``return_numpy=False`` from ``create_lod_tensor(arange(6), [[2, 1,
    3]])`` give lod ``[[0, 2, 3, 6]]`` exactly, in both packages."""
    data = np.arange(6).reshape(6, 1)
    got = {}
    for name, fl in (("jax", jfluid), ("torch", tfluid)):
        main, startup, outs = _lod_fetch_program(fl)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope()
        exe.run(startup, scope=scope)
        feed = {"ids": fl.create_lod_tensor(data.astype("int64"),
                                            [[2, 1, 3]], fl.CPUPlace()),
                "words": fl.create_lod_tensor(data.astype("float32"),
                                              [[2, 1, 3]], fl.CPUPlace())}
        got[name] = exe.run(main, feed=feed, fetch_list=outs, scope=scope,
                            return_numpy=False)
    for j, t in zip(got["jax"], got["torch"]):
        assert type(t).__name__ == "LoDArray"
        assert j.lod() == t.lod() == [[0, 2, 3, 6]]
        assert t.recursive_sequence_lengths() == [[2, 1, 3]]


def _fc_after_embedding(fl):
    """F-18's probe: ragged ids -> embedding -> fc(num_flatten_dims=2,
    tanh), the head of every sequence model before its LSTM or pool."""
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = main.random_seed = 11
    with fl.program_guard(main, startup):
        ids = fl.layers.data(name="ids", shape=[1], dtype="int64", lod_level=1)
        emb = fl.layers.embedding(ids, size=[20, 4])
        hid = fl.layers.fc(emb, size=3, num_flatten_dims=2, act="tanh")
    return main, startup, [emb, hid]


def test_fc_keeps_the_lengths_of_its_input():
    """F-18: an output that keeps an input's [batch, time] dims inherits
    its lengths (the JAX package's ``_propagate_lengths``), so ``fc``
    after ``embedding`` fetched with ``return_numpy=False`` gives lengths
    [5, 2, 3] in both packages, where the port gave a plain tensor."""
    seqs = [np.arange(5), np.arange(2) + 5, np.arange(3) + 9]
    got = {}
    for name, fl in (("jax", jfluid), ("torch", tfluid)):
        main, startup, outs = _fc_after_embedding(fl)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope()
        exe.run(startup, scope=scope)
        feed = {"ids": fl.create_lod_tensor(
            [s.reshape(-1, 1).astype("int64") for s in seqs], None)}
        got[name] = exe.run(main, feed=feed, fetch_list=outs, scope=scope,
                            return_numpy=False)
    for j, t in zip(got["jax"], got["torch"]):
        assert type(t).__name__ == "LoDArray"
        np.testing.assert_array_equal(t.lengths, [5, 2, 3])
        np.testing.assert_array_equal(t.lengths, j.lengths)
        assert t.data.shape == j.data.shape


def _dense_program(fl, image):
    """An fc over a dense feed, or (``image``) an fc over im2sequence's
    patches, whose fetch carries lengths in both packages."""
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = main.random_seed = 12
    with fl.program_guard(main, startup):
        if image:
            x = fl.layers.data(name="x", shape=[2, 4, 4], dtype="float32")
            x = fl.layers.im2sequence(x, filter_size=2, stride=2)
        else:
            x = fl.layers.data(name="x", shape=[3, 4], dtype="float32")
        out = fl.layers.fc(x, size=5, num_flatten_dims=2)
    return main, startup, out


@pytest.mark.parametrize("image", [False, True])
def test_binding_is_unchanged_where_no_input_carries_lengths(image):
    """A dense Program binds (one bound entry) as before the length
    propagation; an fc over im2sequence's patches carries their lengths
    to its fetch in both packages, so the port refuses to bind it as a
    ``lod_fetch``."""
    from paddle_tpu_torch import observability as tobs

    refused = tobs.counter("executor.graph_refused", {"op": "lod_fetch"})
    r0 = refused.value
    x = np.random.RandomState(0).randn(
        2, *((2, 4, 4) if image else (3, 4))).astype("float32")
    main, startup, out = _dense_program(tfluid, image)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    runs = [exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope,
                    return_numpy=False)[0] for _ in range(2)]
    bound = [b for b in exe._bound.values() if b.program is main]
    jmain, jstartup, jout = _dense_program(jfluid, image)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    (want,) = jexe.run(jmain, feed={"x": x}, fetch_list=[jout], scope=jscope,
                       return_numpy=False)
    if image:
        assert not bound and refused.value - r0 == 2
        for r in runs:
            np.testing.assert_array_equal(r.lengths, [4, 4])
            np.testing.assert_array_equal(r.lengths, want.lengths)
    else:
        assert len(bound) == 1 and refused.value == r0
        assert not hasattr(want, "lengths")
        assert all(isinstance(r, torch.Tensor) for r in runs)
