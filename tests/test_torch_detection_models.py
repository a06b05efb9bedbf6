"""MobileNet-SSD (``models.ssd``) through the port's Executor against the
JAX package's, on the CPU, at the JAX package's own test size
(``tests/unittests/test_ssd_model.py``: ``img_shape=[3, 96, 96]``,
``scale=0.25``, 21 classes, 240 priors), batch 4, 1-4 seeded boxes an
image fed ragged, RMSProp at 1e-3.

Both packages build the same main, startup and test Programs (the same
``to_string()`` JSON).  The port's startup state (seeded) is copied into
the JAX package, and STEPS steps run on one batch.  Each step starts the
port from the JAX package's state before it, as
``tests/test_torch_resnet.py`` does, because MobileNet's ReLUs and batch
norms (over 4 values a channel in the three last extra blocks, whose
maps are 1 x 1) and the mining's rank at a near-tie make the float32
gradient jump where a gate or a rank flips: at the second step the JAX
package's float32 gradients lie 0.24 of their norm from the float64
step, the port's 0.0024.  So each step is also run by the port in
float64 (the Program widened), the truth both float32 steps are held to:
- the loss, a forward value, within LOSS_RTOL of the JAX package's;
- the gradients of the 12 head convolutions' biases (no gate between
  them and the loss), each within HEAD_L2 of its L2 norm in L2;
- all gradients together, and the change every persistable makes in the
  step (parameters, RMSProp's moments, the running statistics)
  together: the port's within GLOBAL_L2 of the float64 step's in L2
  (ResNet's limit), and the port's within GLOBAL_L2 plus the JAX
  package's own distance from the float64 step of the JAX package's
  (the triangle inequality: that much, and no more, may part two
  float32 steps whose one is GLOBAL_L2 from the truth);
- each running mean and variance after the step within STAT_TOL of its
  largest magnitude.
The test Program (cloned before RMSProp: ``detection_output`` with
``nms_top_k`` 400, ``keep_top_k`` 200) on the last state gives the same
detections: labels and counts exactly, scores and boxes within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import lod as JL
from paddle_tpu.models import ssd as JS
from paddle_tpu_torch import lod as TL
from paddle_tpu_torch.models import ssd as TS

KW = dict(img_shape=[3, 96, 96], scale=0.25)
BATCH, MAX_GT, STEPS = 4, 4, 3
LOSS_RTOL = 1e-4
HEAD_L2 = 5e-3
GLOBAL_L2 = 0.05
STAT_TOL = 5e-4
DET_TOL = 1e-5
_LOD = {id(jfluid): JL, id(tfluid): TL}


def _feed(fl, dtype="float32"):
    rng = np.random.RandomState(40)
    img = rng.rand(BATCH, *KW["img_shape"])
    boxes = np.sort(rng.rand(BATCH, MAX_GT, 2, 2), axis=2).reshape(
        BATCH, MAX_GT, 4)
    labels = rng.randint(1, JS.NUM_CLASSES, size=(BATCH, MAX_GT, 1))
    lens = np.array([4, 2, 3, 1], np.int32)
    lod = _LOD[id(fl)]
    return {"image": img.astype(dtype),
            "gt_box": lod.LoDArray(boxes.astype(dtype), lens),
            "gt_label": lod.LoDArray(labels.astype("int64"), lens)}


def _state(prog, scope):
    return {n: np.array(scope[n]) for n in prog.persistable_names()
            if n in scope and scope[n] is not None}


def _widened(program):
    def wide(o):
        if isinstance(o, dict):
            return {k: wide(v) for k, v in o.items()}
        if isinstance(o, list):
            return [wide(v) for v in o]
        return "float64" if o == "float32" else o
    return tfluid.Program.from_dict(wide(program.to_dict()))


def _port_step(program, state, dtype, fetch):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.load_numpy_state(program, {
        n: v.astype(dtype) if v.dtype.kind == "f" else v
        for n, v in state.items()}, scope=scope, device="cpu")
    out = exe.run(program, feed=_feed(tfluid, dtype), fetch_list=fetch,
                  scope=scope)
    return [np.asarray(o) for o in out], _state(program, scope)


@pytest.fixture(scope="module")
def runs():
    # one intra-op thread: the steps are small, and the suite runs beside
    # other workers on the same cores, where idle OpenMP threads spinning
    # cost far more than they give
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _runs()
    finally:
        torch.set_num_threads(threads)


def _runs():
    with jfluid.unique_name.guard():
        jm = JS.get_model(**KW)
    with tfluid.unique_name.guard():
        tm = TS.get_model(**KW)
    serialized = {k: (jm[k].to_string(), tm[k].to_string())
                  for k in ("main", "startup", "test")}
    tm["startup"].random_seed = 5
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(tm["startup"], scope=tscope)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, v in _state(tm["main"], tscope).items():
        jscope[n] = v
    blk = tm["main"].global_block()
    grads = [p.name + "@GRAD" for p in blk.all_parameters() if p.trainable]
    fetch = [tm["loss"].name] + grads
    main64 = _widened(tm["main"])
    steps = []
    for _ in range(STEPS):
        before = _state(jm["main"], jscope)
        port, port_state = _port_step(tm["main"], before, "float32", fetch)
        wide, wide_state = _port_step(main64, before, "float64", fetch)
        with jfluid.scope_guard(jscope):
            jax = [np.asarray(o) for o in jexe.run(
                jm["main"], feed=_feed(jfluid), fetch_list=fetch)]
        steps.append({"before": before, "grads": grads,
                      "jax": (jax, _state(jm["main"], jscope)),
                      "port": (port, port_state),
                      "f64": (wide, wide_state)})
    test_fetch = [tm["nmsed_out"].name]
    with jfluid.scope_guard(jscope):
        (jdet,) = jexe.run(jm["test"], feed=_feed(jfluid),
                           fetch_list=test_fetch, return_numpy=False)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tm["main"], _state(jm["main"], jscope),
                            scope=tscope, device="cpu")
    (tdet,) = tfluid.Executor(tfluid.CPUPlace()).run(
        tm["test"], feed=_feed(tfluid), fetch_list=test_fetch, scope=tscope,
        return_numpy=False)
    heads = [op.inputs["Y"][0] + "@GRAD" for op in blk.ops
             if op.type == "elementwise_add"
             and any(o.type == "transpose" and o.inputs["X"][0]
                     == op.outputs["Out"][0] for o in blk.ops)]
    stats = [op.outputs[s][0] for op in blk.ops if op.type == "batch_norm"
             for s in ("MeanOut", "VarianceOut")]
    return {"serialized": serialized, "steps": steps, "heads": heads,
            "stats": stats, "detections": (jdet, tdet)}


def _dist(a, b):
    """||a - b|| / ||b|| over lists of arrays together."""
    a, b = ([np.asarray(v, np.float64) for v in vs] for vs in (a, b))
    num = sum(float(np.sum((x - y) ** 2)) for x, y in zip(a, b))
    den = sum(float(np.sum(y ** 2)) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def test_same_programs_as_jax(runs):
    for key, (want, got) in runs["serialized"].items():
        assert got == want, key


def test_losses_match_jax_and_fall(runs):
    losses = [(float(st["jax"][0][0].reshape(-1)[0]),
               float(st["port"][0][0].reshape(-1)[0]))
              for st in runs["steps"]]
    for want, got in losses:
        assert np.isfinite(got) and abs(got - want) <= LOSS_RTOL * abs(want)
    assert losses[-1][1] < losses[0][1], losses


def test_head_gradients_match_jax(runs):
    assert len(runs["heads"]) == 12
    for st in runs["steps"]:
        got = dict(zip(st["grads"], st["port"][0][1:]))
        want = dict(zip(st["grads"], st["jax"][0][1:]))
        for n in runs["heads"]:
            assert _dist([got[n]], [want[n]]) <= HEAD_L2, n


def _changes(st, which, names):
    new = st[which][1]
    return [np.asarray(new[n], np.float64) - st["before"][n] for n in names]


def test_gradients_and_updates_within_the_float64_step(runs):
    for i, st in enumerate(runs["steps"]):
        port, jax, f64 = (st[k][0][1:] for k in ("port", "jax", "f64"))
        own = _dist(port, f64)
        assert own <= GLOBAL_L2, (i, own)
        assert _dist(port, jax) <= GLOBAL_L2 + _dist(jax, f64), i
        names = sorted(st["before"])
        assert sorted(st["port"][1]) == sorted(st["jax"][1]) == names
        port_d, jax_d, f64_d = (_changes(st, k, names)
                                for k in ("port", "jax", "f64"))
        assert _dist(port_d, f64_d) <= GLOBAL_L2, i
        assert _dist(port_d, jax_d) <= GLOBAL_L2 + _dist(jax_d, f64_d), i


def test_running_statistics_match_jax(runs):
    stats = runs["stats"]
    assert len(stats) == 2 * 35
    for st in runs["steps"]:
        for n in stats:
            w, g = st["jax"][1][n], st["port"][1][n]
            assert np.abs(g - w).max() <= STAT_TOL * np.abs(w).max(), n


def test_test_program_detections_match_jax(runs):
    jdet, tdet = runs["detections"]
    want, got = np.asarray(jdet.data), np.asarray(tdet.data)
    assert got.shape == want.shape == (BATCH, 200, 6)
    np.testing.assert_array_equal(np.asarray(tdet.lengths),
                                  np.asarray(jdet.lengths))
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=DET_TOL,
                               atol=DET_TOL)
    assert (got[..., 0] != 0).all()    # the background is never kept
