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
