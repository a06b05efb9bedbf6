"""The port's ``beam_search`` and ``beam_search_decode`` against the JAX
package's rules, on the CPU.

The cases of ``tests/unittests/test_beam_search.py`` and
``test_beam_search_op.py``, each built by both packages' layer
functions (the same ``to_string()`` JSON), run by both, and held to the
reference test's own assertions and to the JAX package's outputs: ids,
parents and lengths exactly (the JAX package's int32 against the port's
int64 by value), scores exactly too — both rules only select and copy
them.  Then seeded cases the reference tests do not reach: exact ties at
-1e9 (step 0's lanes past the first, finished lanes) that must keep
``lax.top_k``'s order, finished lanes frozen among live ones, and
backtraces over arrays with steps past ``@ARRAYLEN`` and both levels of
lengths.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def _build(fl, build):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        fetch = build(fl)
    return main, startup, [f.name for f in fetch]


def _fields(x):
    """A fetch's data and, for a LoDArray, its two levels of lengths."""
    if hasattr(x, "lengths"):
        return x.data, x.lengths, x.sub_lengths
    return (x,)


def both(build, feed, return_numpy=True):
    """``build(fluid)`` by both packages (the same JSON), run on ``feed``
    by each; returns (JAX package outputs, port outputs)."""
    jm, js, fetch = _build(jfluid, build)
    tm, ts, tfetch = _build(tfluid, build)
    assert jm.to_string() == tm.to_string() and fetch == tfetch
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(js)
        j = exe.run(jm, feed=feed, fetch_list=fetch, return_numpy=return_numpy)
    texe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    texe.run(ts, scope=scope)
    t = texe.run(tm, feed=feed, fetch_list=fetch, scope=scope,
                 return_numpy=return_numpy)
    for a, b in zip(j, t):
        for av, bv in zip(_fields(a), _fields(b)):
            av, bv = np.asarray(av), np.asarray(bv)
            assert av.shape == bv.shape, (av.shape, bv.shape)
            np.testing.assert_array_equal(bv, av)
    return j, t


def _beam_search_program(beam, K, end_id, beam_size=None):
    def build(fl):
        L = fl.layers
        pre_ids = L.data(name="pre_ids", shape=[beam], dtype="int64")
        pre_scores = L.data(name="pre_scores", shape=[beam], dtype="float32")
        ids = L.data(name="ids", shape=[beam, K], dtype="int64")
        scores = L.data(name="scores", shape=[beam, K], dtype="float32")
        return list(L.beam_search(pre_ids, pre_scores, ids, scores,
                                  beam_size=beam_size or beam, end_id=end_id))
    return build


# ---------------------------------------------------------------------------
# test_beam_search.py
# ---------------------------------------------------------------------------


def test_beam_search_step():
    # batch=1, beam=2: lane0 candidates (7:-0.5, 8:-2.0), lane1 (9:-1.0, 4:-3.0)
    _, (out_ids, out_scores, out_par) = both(_beam_search_program(2, 2, 0), {
        "pre_ids": np.array([[5, 6]], dtype=np.int64),
        "pre_scores": np.array([[-0.1, -0.2]], dtype=np.float32),
        "ids": np.array([[[7, 8], [9, 4]]], dtype=np.int64),
        "scores": np.array([[[-0.5, -2.0], [-1.0, -3.0]]], dtype=np.float32),
    })
    assert out_ids.tolist() == [[7, 9]]
    np.testing.assert_allclose(out_scores, [[-0.5, -1.0]], rtol=1e-6)
    assert out_par.tolist() == [[0, 1]]
    assert out_ids.dtype == np.int64 and out_par.dtype == np.int32


def test_beam_search_finished_beam_frozen():
    """A lane already at end_id survives with its frozen score and emits
    end_id again (reference beam_search_op.cc end-id handling)."""
    _, (out_ids, out_scores, out_par) = both(_beam_search_program(2, 2, 0), {
        "pre_ids": np.array([[0, 6]], dtype=np.int64),
        "pre_scores": np.array([[-0.3, -0.2]], dtype=np.float32),
        "ids": np.array([[[7, 8], [9, 4]]], dtype=np.int64),
        "scores": np.array([[[-0.5, -2.0], [-0.9, -3.0]]], dtype=np.float32),
    })
    # survivors: frozen lane0 (end_id, -0.3) and lane1's best (9, -0.9)
    assert out_ids.tolist() == [[0, 9]]
    np.testing.assert_allclose(out_scores, [[-0.3, -0.9]], rtol=1e-6)
    assert out_par.tolist() == [[0, 1]]


def _decode_program(steps, capacity, beam=2, end_id=0, read_len=False):
    """Arrays of ``capacity`` rows with ``steps`` steps written from the
    feeds s<t>i / s<t>p / s<t>s, then beam_search_decode."""
    def build(fl):
        L = fl.layers
        ids_arr = L.create_array("int64", capacity=capacity)
        sc_arr = L.create_array("float32", capacity=capacity)
        par_arr = L.create_array("int32", capacity=capacity)
        for t in range(steps):
            i = L.fill_constant(shape=[1], dtype="int64", value=t)
            L.array_write(L.data(name="s%di" % t, shape=[beam], dtype="int64"), i, ids_arr)
            L.array_write(L.data(name="s%ds" % t, shape=[beam], dtype="float32"), i, sc_arr)
            L.array_write(L.data(name="s%dp" % t, shape=[beam], dtype="int32"), i, par_arr)
        out = list(L.beam_search_decode(ids_arr, sc_arr, par_arr,
                                        beam_size=beam, end_id=end_id))
        if read_len:
            out.append(L.array_length(ids_arr))
        return out
    return build


def _two_step_feed(s1i, s1p):
    return {
        "s0i": np.array([[10, 11]], dtype=np.int64),
        "s0p": np.array([[0, 1]], dtype=np.int32),
        "s0s": np.array([[-0.1, -0.2]], dtype=np.float32),
        "s1i": np.array([s1i], dtype=np.int64),
        "s1p": np.array([s1p], dtype=np.int32),
        "s1s": np.array([[-0.4, -0.6]], dtype=np.float32),
    }


def test_beam_search_decode_backtrace():
    """Two scripted steps: the backtrace crosses parent lanes."""
    # step1 tokens [12, 13] where BOTH step-1 lanes descend from lane 1
    _, (out_ids, out_scores) = both(_decode_program(2, 4),
                                    _two_step_feed([12, 13], [1, 1]))
    # rows are hypotheses ([B*beam, capacity]); positions past the 2
    # written steps are end_id padding
    assert out_ids[0].tolist() == [11, 12, 0, 0]
    assert out_ids[1].tolist() == [11, 13, 0, 0]
    np.testing.assert_allclose(out_scores, [-0.4, -0.6], rtol=1e-6)


def test_beam_search_decode_nested_lod_output():
    """return_numpy=False hands back the reference's 2-level structure:
    rows = hypotheses, lengths = per-hypothesis token counts (through the
    first end_id), sub_lengths = beam rows per source sentence."""
    _, (got_ids, got_scores) = both(
        _decode_program(2, 4), _two_step_feed([12, 0], [0, 1]),
        return_numpy=False)
    assert isinstance(got_ids, tfluid.LoDArray)
    assert got_ids.lod_level == 2
    # 1 source x 2 beams; lane0 ran 2 full steps, lane1 ended at step 1
    assert got_ids.recursive_sequence_lengths() == [[2], [2, 2]]
    assert got_ids.has_valid_recursive_sequence_lengths()
    assert np.asarray(got_ids.data)[1, :2].tolist() == [11, 0]
    assert got_scores.recursive_sequence_lengths() == [[2], [1, 1]]


# ---------------------------------------------------------------------------
# test_beam_search_op.py
# ---------------------------------------------------------------------------


def test_beam_search_step_topk():
    # batch 1, beam 2, K=4 candidates/beam; scores are ACCUMULATED log-probs
    pre_scores = np.array([[-0.5, -1.0]], "float32")
    probs = np.array([[[0.4, 0.3, 0.2, 0.1],
                       [0.1, 0.2, 0.3, 0.4]]], "float32")
    acc = pre_scores[..., None] + np.log(probs)  # [1, 2, 4]
    _, (got_ids, got_scores, got_parent) = both(_beam_search_program(2, 4, 0), {
        "pre_ids": np.array([[1, 2]], "int64"), "pre_scores": pre_scores,
        "ids": np.tile(np.arange(4, dtype="int64")[None, None, :], (1, 2, 1)),
        "scores": acc})
    flat = acc[0].reshape(-1)
    top = np.argsort(-flat)[:2]
    np.testing.assert_allclose(np.ravel(got_scores), flat[top], rtol=1e-4)
    np.testing.assert_array_equal(np.ravel(got_ids), top % 4)
    np.testing.assert_array_equal(np.ravel(got_parent), top // 4)


# ---------------------------------------------------------------------------
# seeded cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_beam_search_ties_and_finished_lanes(seed):
    """Step 0's layout (every lane past the first at -1e9, all lanes the
    same candidates: exact ties) and a later step with finished lanes,
    for B=3, beam=4, K=4: ids, scores and parents as the JAX rule gives
    them, ties in lax.top_k's order."""
    B, beam, K, end_id = 3, 4, 4, 1
    rng = np.random.RandomState(seed)
    cand = np.sort(rng.rand(B, 1, K).astype("float32"), -1)[..., ::-1]
    logp = np.log(np.repeat(cand, beam, axis=1))           # [B, beam, K]
    ids = np.repeat(rng.randint(3, 50, size=(B, 1, K)), beam, 1).astype("int64")
    pre0 = np.where(np.arange(beam) == 0, 0.0, -1e9).astype("float32")
    pre0 = np.repeat(pre0[None], B, 0)
    step0 = {"pre_ids": np.full((B, beam), 2, "int64"), "pre_scores": pre0,
             "ids": ids, "scores": (logp + pre0[..., None]).astype("float32")}
    assert np.sum(step0["scores"] == np.float32(-1e9)) >= B * (beam - 1) * K
    _, (sel, sc, par) = both(_beam_search_program(beam, K, end_id), step0)
    # lane 0 holds the only scores above -1e9: its K candidates, in order
    assert (par == 0).all()
    np.testing.assert_array_equal(sel, ids[:, 0])

    pre_ids = rng.randint(3, 50, size=(B, beam)).astype("int64")
    pre_ids[0, 1] = pre_ids[1, 0] = pre_ids[1, 3] = end_id
    pre_ids[2] = end_id  # every lane of source 2 finished
    pre = -np.sort(rng.rand(B, beam).astype("float32") * 3, -1)
    pre[2, 1:] = -1e9
    stepn = {"pre_ids": pre_ids, "pre_scores": pre,
             "ids": rng.randint(3, 50, size=(B, beam, K)).astype("int64"),
             "scores": (pre[..., None] + np.log(rng.rand(B, beam, K))).astype("float32")}
    _, (sel, sc, par) = both(_beam_search_program(beam, K, end_id), stepn)
    # a finished lane's frozen score survives with end_id; source 2's
    # other slots all tie at -1e9, and the lowest flat index, lane 0's own
    # slots, wins each tie
    assert sel[2].tolist() == [end_id] * beam
    np.testing.assert_array_equal(sc[2], pre[2])
    assert par[2].tolist() == [0] * beam
    assert end_id in sel[0].tolist() and end_id in sel[1].tolist()
    assert (np.diff(sc, axis=1) <= 0).all()


@pytest.mark.parametrize("steps,capacity", [(1, 4), (3, 6), (5, 5)])
def test_beam_search_decode_random_steps(steps, capacity):
    """Random ids (end_id among them), parents and scores over ``steps``
    written steps of a ``capacity``-row array, B=2, beam=3: sentence ids,
    both levels of lengths and scores as the JAX rule gives them; rows
    are end_id past the written steps."""
    B, beam, end_id = 2, 3, 1
    rng = np.random.RandomState(steps * 10 + capacity)
    feed = {}
    for t in range(steps):
        feed["s%di" % t] = rng.randint(0, 6, size=(B, beam)).astype("int64")
        feed["s%dp" % t] = rng.randint(0, beam, size=(B, beam)).astype("int32")
        feed["s%ds" % t] = -np.sort(rng.rand(B, beam), -1).astype("float32")
    _, (ids, scores, n) = both(
        _decode_program(steps, capacity, beam, end_id, read_len=True), feed,
        return_numpy=False)
    assert int(np.asarray(n)[0]) == steps
    data = np.asarray(ids.data)
    assert data.shape == (B * beam, capacity)
    assert (data[:, steps:] == end_id).all()
    assert ids.sub_lengths.tolist() == [beam] * B
    assert ((ids.lengths >= 1) & (ids.lengths <= steps)).all()
    np.testing.assert_array_equal(np.asarray(scores.data),
                                  feed["s%ds" % (steps - 1)].reshape(-1))
