"""The port's host-side tools against the JAX package's on the CPU:
``metrics``, ``average``, ``evaluator``, ``debugger``, ``net_drawer``,
``contrib.op_frequence`` and ``fluid_format``.

The metrics and ``WeightedAverage`` are fed the same updates in both
packages, the port's also as what its ``Executor.run`` fetches (a
``LazyFetch`` or a tensor): ``eval`` gives the same numbers (float
equality: the same numpy arithmetic on the same values), and the same
errors.  The three evaluators run their Programs through each package's
``Executor.run`` on the same seeded batches for two passes with a
``reset`` between them: each pass's ``eval`` is the JAX package's.  In
the port ``reset`` fills the state tensors in place, so a bound step
stays bound (no new capture, the same tensor objects).  The Program
tools give the same text for the same Program, and a directory the JAX
package's ``save_fluid_persistables`` wrote loads bit for bit into a
port scope, whose own files are byte-identical to the JAX package's.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import fluid_format as JF
from paddle_tpu_torch import executor as texe
from paddle_tpu_torch import fluid_format as TF
from test_torch_sequence_ops import Ragged, _feed

CPU = tfluid.CPUPlace()


def _kinds(arr):
    """``arr`` as the port's fetches come: numpy, a ``LazyFetch`` and a
    tensor."""
    return [arr, texe.LazyFetch(torch.as_tensor(np.asarray(arr))),
            torch.as_tensor(np.asarray(arr))]


def _updates(name):
    r = np.random.RandomState(sum(map(ord, name)))
    if name in ("Precision", "Recall"):
        return [(r.rand(12, 1), r.randint(0, 2, (12, 1))) for _ in range(3)]
    if name == "Accuracy":
        return [(np.array([r.rand()], "float32"), int(r.randint(1, 9)))
                for _ in range(3)]
    if name == "ChunkEvaluator":
        return [tuple(np.array([r.randint(0, 9)], "int64") for _ in range(3))
                for _ in range(3)]
    if name == "EditDistance":
        return [(r.randint(0, 3, (5, 1)).astype("float32"),
                 np.array([5], "int64")) for _ in range(3)]
    if name == "Auc":
        p = r.rand(40, 1)
        return [(np.hstack([1 - p, p]), r.randint(0, 2, (40, 1)))
                for _ in range(2)]
    if name == "DetectionMAP":
        out = []
        for _ in range(2):
            det = np.full((2, 4, 6), -1.0, "float32")
            det[:, :3, 0] = r.randint(1, 3, (2, 3))
            det[:, :3, 1] = r.rand(2, 3)
            det[:, :3, 2:4] = r.rand(2, 3, 2)
            det[:, :3, 4:] = det[:, :3, 2:4] + r.rand(2, 3, 2)
            gtb = np.concatenate([det[:, :2, 2:4], det[:, :2, 4:]], axis=2)
            gtb = gtb + r.uniform(-0.1, 0.1, gtb.shape).astype("float32")
            out.append((det, gtb, r.randint(1, 3, (2, 2)),
                        np.array([2, 1], "int64")))
        return out
    raise KeyError(name)


METRICS = ["Precision", "Recall", "Accuracy", "ChunkEvaluator",
           "EditDistance", "Auc", "DetectionMAP"]


def _make(fl, name):
    cls = getattr(fl.metrics, name)
    return cls(num_classes=3) if name == "DetectionMAP" else cls()


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("name", METRICS)
def test_metrics_eval_the_jax_packages_numbers(name, kind):
    j, t = _make(jfluid, name), _make(tfluid, name)
    for args in _updates(name):
        j.update(*args)
        t.update(*[_kinds(a)[kind] if isinstance(a, np.ndarray) else a
                   for a in args])
    assert t.eval() == j.eval()
    assert str(t) == str(j) == name
    t.reset()
    j.reset()
    assert t.get_config()["states"].keys() == j.get_config()["states"].keys()


def test_composite_metric_and_detection_map_helpers():
    pj, pt = jfluid.metrics.CompositeMetric(), tfluid.metrics.CompositeMetric()
    for fl, c in ((jfluid, pj), (tfluid, pt)):
        c.add_metric(fl.metrics.Precision())
        c.add_metric(fl.metrics.Recall())
    for preds, labels in _updates("Precision"):
        pj.update(preds, labels)
        pt.update(_kinds(preds)[1], _kinds(labels)[2])
    assert pt.eval() == pj.eval()
    with pytest.raises(ValueError):
        pt.add_metric("not a metric")
    det, gtb, gtl, lens = _updates("DetectionMAP")[0]
    for ap in ("integral", "11point"):
        want = jfluid.metrics.compute_detection_map(
            det, gtb, gtl, lens, num_classes=3, ap_version=ap)
        got = tfluid.metrics.compute_detection_map(
            *_kinds(det)[2:], gtb, gtl, _kinds(lens)[1], num_classes=3,
            ap_version=ap)
        assert got == want
    m = tfluid.metrics.DetectionMAP(num_classes=3)
    m.update(np.array([0.25]))
    m.update(texe.LazyFetch(torch.tensor([0.75])))
    assert m.eval() == 0.5
    m.update(det, gtb, gtl, lens)
    with pytest.raises(ValueError, match="cannot be combined"):
        m.eval()


@pytest.mark.parametrize("name", ["Accuracy", "EditDistance", "DetectionMAP"])
def test_metrics_raise_as_the_jax_package_does(name):
    for fl in (jfluid, tfluid):
        with pytest.raises(ValueError):
            _make(fl, name).eval()
    for fl in (jfluid, tfluid):
        with pytest.raises(ValueError):
            fl.metrics.Accuracy().update(np.array([0.5, 0.5]), 2)


def test_weighted_average_matches_jax_with_its_errors():
    adds = [(1.5, 2), (np.array([1.0, 3.0]), 1), (np.float32(4.0),
                                                   np.array([3]))]
    j, t = jfluid.average.WeightedAverage(), tfluid.average.WeightedAverage()
    for value, weight in adds:
        j.add(value, weight)
    for (value, weight), kind in zip(adds, (0, 1, 2)):
        value = _kinds(np.asarray(value))[kind]
        weight = _kinds(np.asarray(weight))[2 - kind]
        t.add(value, weight)
    assert t.eval() == j.eval()
    for fl in (jfluid, tfluid):
        avg = fl.average.WeightedAverage()
        with pytest.raises(ValueError, match="before any add"):
            avg.eval()
        with pytest.raises(ValueError, match="weight must be a number"):
            avg.add(1.0, "2")
        with pytest.raises(ValueError, match="got a string"):
            avg.add("1", 2)
        avg.add(1.0, 0)
        with pytest.raises(ValueError, match="sum to zero"):
            avg.eval()


# ---------------------------------------------------------------------------
# evaluators through Executor.run
# ---------------------------------------------------------------------------

def _chunk(fl, v):
    return fl.evaluator.ChunkEvaluator(v["i"], v["l"], chunk_scheme="IOB",
                                       num_chunk_types=3)


def _edit(fl, v):
    return fl.evaluator.EditDistance(v["h"], v["r"])


def _det_map(fl, v):
    return fl.evaluator.DetectionMAP(v["d"], v["gl"], v["gb"], class_num=3,
                                     state_capacity=16)


def _chunk_batches(seed):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        lab = r.randint(0, 7, (4, 8)).astype("int64")
        inf = np.where(r.rand(4, 8) < 0.3, r.randint(0, 7, (4, 8)), lab)
        out.append({"i": Ragged(inf.astype("int64"), [8, 5, 7, 3]),
                    "l": Ragged(lab, [8, 5, 7, 3])})
    return out


def _edit_batches(seed):
    r = np.random.RandomState(seed)
    return [{"h": Ragged(r.randint(0, 5, (3, 6)).astype("int64"), [6, 2, 4]),
             "r": Ragged(r.randint(0, 5, (3, 6)).astype("int64"), [5, 6, 1])}
            for _ in range(2)]


def _det_batches(seed):
    return [{"d": det, "gb": gtb, "gl": gtl.astype("int64")}
            for det, gtb, gtl, _ in _updates("DetectionMAP")]


EVALUATORS = {"chunk": (_chunk, _chunk_batches),
              "edit_distance": (_edit, _edit_batches),
              "detection_map": (_det_map, _det_batches)}


def _declare(fl, batch):
    vs = {}
    for n, v in batch.items():
        a = v.data if isinstance(v, Ragged) else v
        vs[n] = fl.layers.data(name=n, shape=list(a.shape[1:] if isinstance(
            v, Ragged) else a.shape[1:]), dtype=str(a.dtype),
            lod_level=1 if isinstance(v, Ragged) else 0)
    return vs


def _evaluate(fl, case, dense=False):
    """Two passes of the case's batches through ``fl``'s Executor with a
    ``reset`` between them: each pass's ``eval``, the port's scope
    tensors before and after the reset, and the captures the reset
    caused."""
    make, batches = EVALUATORS[case]
    data = batches(3)
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        ev = make(fl, _declare(fl, data[0]))
    scope, out = fl.Scope(), {"evals": []}
    feeds = [(_feed(b)(fl) if not dense else
              {n: (v.data if isinstance(v, Ragged) else v)
               for n, v in b.items()}) for b in data]
    with fl.scope_guard(scope):
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup)
        c_start = texe.compile_count()
        for p in range(2):
            if p:
                held = {v.name: scope[v.name] for v in ev.states}
                c0 = texe.compile_count()
                out["captures_before_reset"] = c0 - c_start
                ev.reset(exe)
                out["same_objects"] = all(scope[n] is t
                                          for n, t in held.items())
            for _ in range(2):
                for f in feeds:
                    exe.run(main, feed=f, fetch_list=ev.metrics)
            if p and fl is tfluid:
                out["captures_after_reset"] = texe.compile_count() - c0
            out["evals"].append([np.asarray(e) for e in ev.eval(exe)]
                                if case != "detection_map" else None)
        if case == "detection_map":
            out["evals"] = [np.asarray(exe.run(main, feed=feeds[0],
                                               fetch_list=[ev.accum_map])[0])]
    return out


@pytest.mark.parametrize("case", list(EVALUATORS))
def test_evaluators_match_jax_and_reset_in_place(case):
    want, got = _evaluate(jfluid, case), _evaluate(tfluid, case)
    assert len(got["evals"]) == len(want["evals"])
    assert any(np.any(np.asarray(a) != 0) for e in got["evals"] if e
               for a in e) or case == "detection_map"
    for w, g in zip(want["evals"], got["evals"]):
        if w is None:
            continue
        for a, b in zip(w, g):
            np.testing.assert_allclose(b, a, rtol=1e-6)
    assert got["same_objects"]


@pytest.mark.parametrize("case", list(EVALUATORS))
def test_a_dense_fed_evaluator_stays_bound_across_reset(case):
    """Fed dense batches (full rows: no lengths), the step binds and is
    captured once; ``reset`` captures nothing new."""
    got = _evaluate(tfluid, case, dense=True)
    assert got["captures_before_reset"] == 1
    assert got["same_objects"] and got["captures_after_reset"] == 0


# ---------------------------------------------------------------------------
# Program tools
# ---------------------------------------------------------------------------

def _net(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        img = fl.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        c = fl.layers.conv2d(img, num_filters=4, filter_size=3, act="relu")
        p = fl.layers.pool2d(c, pool_size=2, pool_stride=2)
        loss = fl.layers.mean(fl.layers.fc(p, size=5, act="softmax"))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup


def test_program_tools_give_the_jax_packages_text(tmp_path):
    (jm, js), (tm, _) = _net(jfluid), _net(tfluid)
    assert tfluid.debugger.repr_program(tm) == jfluid.debugger.repr_program(jm)
    texts = []
    for fl, m in ((jfluid, jm), (tfluid, tm)):
        path = str(tmp_path / (fl.__name__ + ".dot"))
        fl.debugger.draw_block_graphviz(m.global_block(),
                                        highlights=["img"], path=path)
        from importlib import import_module

        drawn = import_module(fl.__name__ + ".net_drawer").draw_graph(
            js, m, path=path + ".net")
        texts.append((open(path).read(), open(drawn).read()))
    assert texts[0] == texts[1] and "digraph G" in texts[1][0]
    assert (tfluid.contrib.op_freq_statistic(tm)
            == jfluid.contrib.op_freq_statistic(jm))
    uni, pair = tfluid.contrib.op_freq_statistic(tm)
    assert uni["conv2d"] == 1 and sum(pair.values()) == len(
        tm.global_block().ops) - 1


def test_fluid_format_round_trips_byte_for_byte(tmp_path):
    r = np.random.RandomState(9)
    state = {"w": r.randn(3, 4).astype("float32"),
             "b": r.randn(7).astype("float64"),
             "ids": r.randint(0, 50, (2, 5)).astype("int64"),
             "q": r.randint(-127, 128, (4, 4)).astype("int8"),
             "m": (r.rand(6) > 0.5)}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JF.save_fluid_persistables(jdir, state)
    scope = tfluid.Scope()
    scope["w"] = torch.zeros(3, 4)          # the scope's device: the CPU
    loaded = TF.load_fluid_persistables(jdir, scope=scope)
    assert sorted(loaded) == sorted(state)
    for n, a in state.items():
        t = scope[n]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        got = texe.as_numpy(t)
        assert got.dtype == a.dtype and got.tobytes() == a.tobytes(), n
    TF.save_fluid_persistables(tdir, {n: scope[n] for n in state})
    for n in state:
        with open(os.path.join(jdir, n), "rb") as f, \
                open(os.path.join(tdir, n), "rb") as g:
            assert f.read() == g.read(), n
    # the reference's IOError on a corrupt file
    with open(os.path.join(tdir, "w"), "r+b") as f:
        f.truncate(30)
    with pytest.raises(IOError, match="corrupt"):
        JF.load_fluid_persistables(tdir)
    with pytest.raises(IOError, match="corrupt"):
        TF.load_fluid_persistables(tdir, scope=tfluid.Scope(), device="cpu")
