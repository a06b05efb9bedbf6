"""The port's ``ParallelExecutor``, ``build_mesh``, ``Executor.attach_mesh``,
``shard_feed_list``, ``layers.get_places`` and ``Trainer(parallel=)`` on a
one-device mesh, on the CPU, and their first step onto two ranks (the
multi-rank cases are ``test_torch_mesh_executor.py``'s).

The one-device cases of ``tests/unittests/test_parallel_executor.py``:
the port's ``ParallelExecutor`` on the CPU against the JAX package's on
its 8-device CPU mesh (``tests/conftest.py`` forces 8 host devices),
from the same numpy parameters and batches: each loss within LOSS_RTOL
and the first weight within the reference test's rtol 1e-5, atol 1e-6.
Port against port (``ParallelExecutor`` against ``Executor.run``,
``Trainer(parallel=True)`` against ``Trainer()``, a feed list against
its merged dict): bitwise.  A mesh of two ranks named by ``devices``
(``["cpu", "cpu"]``) runs the JAX package's dp-2 steps within its
limits; one that needs more devices than it is given raises the JAX
package's ``ValueError``, its message verbatim.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import parallel_executor as JPE
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import parallel_executor as TPE
from paddle_tpu_torch.reader import device_prefetch

LOSS_RTOL = 1e-5
CPU = ["cpu"]


def _mlp(fl):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="int64")
        h = L.fc(input=x, size=16, act="relu")
        p = L.fc(input=h, size=4, act="softmax")
        loss = L.mean(L.cross_entropy(input=p, label=y))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _batch(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 8).astype("float32"),
            "y": rng.randint(0, 4, size=(n, 1)).astype("int64")}


def _started(seed=21):
    main, startup, loss = _mlp(tfluid)
    startup.random_seed = seed
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    return main, loss, scope


def _state(prog, scope):
    return {n: np.array(scope[n]) for n in prog.persistable_names()
            if n in scope and scope[n] is not None}


def test_parallel_matches_single_device():
    """5 SGD steps: the port's ParallelExecutor on one CPU device against
    the JAX package's over its dp-8 mesh, and bitwise against the port's
    own Executor.run."""
    import jax

    assert jax.device_count() >= 8
    feed = _batch()
    main, loss, scope = _started()
    state = _state(main, scope)
    pexe = tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                   scope=scope, devices=CPU)
    assert pexe.device_count == 1
    got = [np.asarray(pexe.run(fetch_list=[loss], feed=feed)[0])
           for _ in range(5)]
    w_got = np.array(scope["fc_0.w_0"])

    main2, loss2, scope2 = _started()
    exe = tfluid.Executor(tfluid.CPUPlace())
    plain = [np.asarray(exe.run(main2, feed=feed, fetch_list=[loss2],
                                scope=scope2)[0]) for _ in range(5)]
    assert [a.tobytes() for a in got] == [a.tobytes() for a in plain]
    assert all(np.array(scope2[n]).tobytes() == np.array(scope[n]).tobytes()
               for n in state)

    jm, _, jloss = _mlp(jfluid)
    assert jm.to_string() == main.to_string()
    jscope = jfluid.Scope()
    for n, v in state.items():
        jscope[n] = v
    with jfluid.scope_guard(jscope):
        jpexe = jfluid.ParallelExecutor(loss_name=jloss.name, main_program=jm)
        assert jpexe.device_count == 8
        want = [float(np.ravel(jpexe.run(fetch_list=[jloss], feed=feed)[0]).mean())
                for _ in range(5)]
        w_want = np.asarray(jscope["fc_0.w_0"])
    np.testing.assert_allclose([float(np.ravel(a).mean()) for a in got], want,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(w_got, w_want, rtol=1e-5, atol=1e-6)


def test_attach_mesh_invalidates_compiled_cache():
    """Bound entries made before attach_mesh are dropped; the next runs
    bind and capture again, with the same bits."""
    main, loss, scope = _started(seed=5)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = _batch(16, seed=1)
    v1 = [np.asarray(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
          for _ in range(2)]
    assert len(exe._bound) == 1 and exe._mesh is None
    mesh = exe.attach_mesh({"dp": 1}, sharding_rules=[("fc_0.*", None)],
                           zero_stage=1)
    assert len(exe._bound) == 0 and exe._mesh is mesh
    assert mesh.shape == {"dp": 1} and mesh.axis_names == ("dp",)
    c0 = texecutor.compile_count()
    v2 = [np.asarray(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
          for _ in range(3)]
    assert len(exe._bound) == 1 and texecutor.compile_count() == c0 + 1
    # the same steps from the same start, on an Executor without a mesh
    main3, loss3, scope3 = _started(seed=5)
    exe3 = tfluid.Executor(tfluid.CPUPlace())
    want = [np.asarray(exe3.run(main3, feed=feed, fetch_list=[loss3],
                                scope=scope3)[0]) for _ in range(5)]
    assert [a.tobytes() for a in v1 + v2] == [a.tobytes() for a in want]


@pytest.mark.parametrize("spec,names,shape", [
    (None, ("dp",), (1,)), (True, ("dp",), (1,)), ((1,), ("dp",), (1,)),
    ((1, 1), ("dp", "tp"), (1, 1)), ({"dp": 1, "pp": 1}, ("dp", "pp"), (1, 1)),
])
def test_build_mesh_lays_out_one_device(spec, names, shape):
    mesh = TPE.build_mesh(spec, devices=CPU)
    assert mesh.axis_names == names and mesh.devices.shape == shape
    assert mesh.size == 1 and list(mesh.devices.flat) == [torch.device("cpu")]


@pytest.mark.parametrize("spec", [{"dp": 2}, (2, 1), (1, 1, 4), {"pp": 2, "dp": 1}])
def test_build_mesh_raises_the_reference_value_error(spec):
    """Too few devices: the JAX package's ValueError, its message first."""
    import jax

    with pytest.raises(ValueError) as want:
        JPE.build_mesh(spec, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        TPE.build_mesh(spec, devices=CPU)
    assert str(got.value) == str(want.value)


def test_a_mesh_of_more_devices_raises_naming_a11_2():
    """Two ranks on the CPU: ParallelExecutor, attach_mesh and a feed
    list run the JAX package's dp-2 steps (losses within LOSS_RTOL, the
    first weight within 1e-5, 1e-6); without devices= the place still
    has one device, and the Trainer raises the reference's ValueError."""
    import jax

    feed = _batch()
    main, loss, scope = _started()
    state = _state(main, scope)
    pexe = tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                   scope=scope, devices=["cpu", "cpu"])
    assert pexe.device_count == 2 and pexe._mesh.shape == {"dp": 2}
    got = [float(np.ravel(pexe.run(fetch_list=[loss], feed=feed)[0])[0])
           for _ in range(3)]
    main2, loss2, scope2 = _started()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.attach_mesh({"dp": 2}, devices=["cpu", "cpu"])
    halves = [{k: v[:16] for k, v in feed.items()},
              {k: v[16:] for k, v in feed.items()}]
    placed = device_prefetch.shard_feed_list(
        halves, exe._mesh, {"x", "y"}, program=main2)
    got2 = [float(np.ravel(exe.run(main2, feed=placed, fetch_list=[loss2],
                                   scope=scope2)[0])[0]) for _ in range(3)]
    assert got2 == got
    jm, _, jloss = _mlp(jfluid)
    jscope = jfluid.Scope()
    for n, v in state.items():
        jscope[n] = v
    with jfluid.scope_guard(jscope):
        jpexe = jfluid.ParallelExecutor(loss_name=jloss.name, main_program=jm,
                                        devices=jax.devices()[:2])
        want = [float(np.ravel(jpexe.run(fetch_list=[jloss], feed=feed)[0]).mean())
                for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(np.array(scope["fc_0.w_0"]),
                               np.asarray(jscope["fc_0.w_0"]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="only 1 available"):
        tfluid.Trainer(_train_func, _optimizer_func, place=tfluid.CPUPlace(),
                       parallel={"dp": 2})


def test_strategies_and_signatures_match_the_reference():
    for name in ("BuildStrategy", "ExecutionStrategy"):
        want, got = getattr(JPE, name)(), getattr(TPE, name)()
        assert vars(got) == vars(want), name
    for cls in ("ReduceStrategy", "GradientScaleStrategy"):
        want = getattr(JPE.BuildStrategy, cls)
        got = getattr(TPE.BuildStrategy, cls)
        assert {k: v for k, v in vars(got).items() if not k.startswith("_")} \
            == {k: v for k, v in vars(want).items() if not k.startswith("_")}
    for fn in ("build_mesh", "ParallelExecutor.__init__", "ParallelExecutor.run"):
        j, t = JPE, TPE
        for part in fn.split("."):
            j, t = getattr(j, part), getattr(t, part)
        assert inspect.signature(t) == inspect.signature(j), fn
    assert inspect.signature(tfluid.Executor.attach_mesh) == inspect.signature(
        jfluid.Executor.attach_mesh)
    assert inspect.signature(tfluid.layers.get_places) == inspect.signature(
        jfluid.layers.get_places)
    for name in ("ParallelExecutor", "BuildStrategy", "ExecutionStrategy"):
        assert name in tfluid.__all__ and name in jfluid.__all__


def test_get_places():
    cpu = torch.device("cpu")
    assert tfluid.layers.get_places(device_type="cpu") == [cpu]
    assert tfluid.layers.get_places(device_count=1, device_type="CPU") == [cpu]
    assert tfluid.layers.get_places(device_type="tpu") == []
    with pytest.raises(ValueError, match="unknown device_type"):
        tfluid.layers.get_places(device_type="fpga")
    with pytest.raises(ValueError, match="device_count must be positive"):
        tfluid.layers.get_places(device_count=0, device_type="cpu")
    if torch.cuda.is_available():
        cards = tfluid.layers.get_places()
        assert cards and all(d.type == "cuda" for d in cards)
    else:
        for kind in (None, "gpu", "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tfluid.layers.get_places(device_type=kind)


def test_a_feed_list_is_one_batch():
    """Per-device feed dicts: each data var's entries copied into one
    batch on the mesh's device (one transfer an entry), with the bits of
    the merged dict's run."""
    feed = _batch(16, seed=3)
    halves = [{k: v[:8] for k, v in feed.items()},
              {k: v[8:] for k, v in feed.items()}]
    main, loss, scope = _started(seed=9)
    pexe = tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                   scope=scope, devices=CPU)
    t0 = device_prefetch.transfer_count()
    stitched = device_prefetch.shard_feed_list(halves, pexe._mesh,
                                               pexe._data_names(), program=main)
    assert device_prefetch.transfer_count() - t0 == 4
    assert stitched["y"].dtype == torch.int64 and stitched["x"].device.type == "cpu"
    assert all(np.array_equal(stitched[k].numpy(), feed[k]) for k in feed)
    got = [np.asarray(pexe.run(fetch_list=[loss], feed=halves)[0])
           for _ in range(3)]
    main2, loss2, scope2 = _started(seed=9)
    pexe2 = tfluid.ParallelExecutor(loss_name=loss2.name, main_program=main2,
                                    scope=scope2, devices=CPU)
    want = [np.asarray(pexe2.run(fetch_list=[loss2], feed=feed)[0])
            for _ in range(3)]
    assert [a.tobytes() for a in got] == [a.tobytes() for a in want]
    # a single-entry list keeps its values; a non-data name concatenates
    one = device_prefetch.shard_feed_list([feed], pexe._mesh, {"x", "y"})
    assert one["x"] is feed["x"]
    extra = device_prefetch.shard_feed_list(
        [{"z": np.ones(2)}, {"z": np.zeros(2)}], pexe._mesh, {"x"})
    assert isinstance(extra["z"], np.ndarray) and extra["z"].tolist() == [1, 1, 0, 0]


def test_fast_path_off_runs_op_by_op_with_the_same_bits():
    feed = _batch(16, seed=4)
    out = []
    for fast in (True, False):
        main, loss, scope = _started(seed=12)
        pexe = tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                       scope=scope, devices=CPU)
        pexe.fast_path = fast
        assert pexe.fast_path is fast
        out.append([np.asarray(pexe.run(fetch_list=[loss], feed=feed)[0])
                    .tobytes() for _ in range(3)])
        assert len(pexe._exe._bound) == (1 if fast else 0)
    assert out[0] == out[1]


def test_flash_attention_transformer_on_a_one_device_mesh():
    """Transformer training with use_flash=True through ParallelExecutor
    (the flash_attention rule reads the mesh: an sp axis of 1) has the
    bits of Executor.run."""
    from paddle_tpu_torch.models import transformer as TT

    cfg = dict(batch_size=2, seq_len=8, src_vocab_size=16, trg_vocab_size=16,
               max_length=8, n_layer=1, n_head=2, d_model=16, d_inner=32,
               dropout=0.1, use_flash=True)
    rng = np.random.RandomState(6)
    feed = {n: rng.randint(1, 16, size=(2, 8)).astype("int64")
            for n in ("src_word", "trg_word", "lbl_word")}
    runs = []
    for parallel in (False, True):
        with tfluid.unique_name.guard():
            m = TT.get_model(**cfg)
        m["startup"].random_seed = m["main"].random_seed = 3
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(m["startup"], scope=scope)
        if parallel:
            pexe = tfluid.ParallelExecutor(loss_name=m["loss"].name,
                                           main_program=m["main"],
                                           scope=scope, devices=CPU)
            run = lambda: pexe.run(fetch_list=[m["loss"]], feed=feed)  # noqa: E731
        else:
            run = lambda: exe.run(m["main"], feed=feed,  # noqa: E731
                                  fetch_list=[m["loss"]], scope=scope)
        runs.append([np.asarray(run()[0]).tobytes() for _ in range(3)])
    assert runs[0] == runs[1]


def _train_func():
    L = tfluid.layers
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="int64")
    h = L.fc(input=x, size=16, act="relu")
    return L.mean(L.cross_entropy(input=L.fc(input=h, size=4, act="softmax"),
                                  label=y))


def _optimizer_func():
    return tfluid.optimizer.SGD(learning_rate=0.1)


def _infer_func():
    L = tfluid.layers
    x = L.data(name="x", shape=[8], dtype="float32")
    h = L.fc(input=x, size=16, act="relu")
    return L.fc(input=h, size=4, act="softmax")


@pytest.mark.parametrize("kw", [
    dict(parallel=True),
    dict(parallel={"dp": 1}, zero_stage=1, sharding_rules=[("fc_0.*", None)]),
])
def test_a_parallel_trainer_takes_the_steps_of_a_trainer(kw, tmp_path):
    """Trainer(parallel=...) on a one-device mesh: the losses and the
    parameters of Trainer()'s steps, bitwise; Inferencer(parallel=True)
    on the saved parameters answers as Inferencer()."""
    feed = _batch(24, seed=5)
    rows = list(zip(feed["x"], feed["y"]))

    def run(**extra):
        np.random.seed(77)  # the startup's seed: one start state for both
        t = tfluid.Trainer(_train_func, _optimizer_func,
                           place=tfluid.CPUPlace(), **extra)
        losses = []
        t.train(num_epochs=1, reader=lambda: iter([rows[:8], rows[8:16],
                                                   rows[16:], rows[:8]]),
                feed_order=["x", "y"],
                event_handler=lambda e: losses.append(
                    np.asarray(e.metrics[0]).tobytes())
                if isinstance(e, tfluid.EndStepEvent) else None)
        return t, losses

    plain, want = run()
    par, got = run(**kw)
    assert len(want) == 4 and got == want
    assert par.exe._mesh.size == 1 and plain.exe._mesh is None
    for p in plain.train_program.global_block().all_parameters():
        assert np.array(par.scope[p.name]).tobytes() == \
            np.array(plain.scope[p.name]).tobytes()
    plain.save_params(str(tmp_path))
    answers = []
    for parallel in (False, True):
        inf = tfluid.Inferencer(_infer_func, str(tmp_path),
                                place=tfluid.CPUPlace(), parallel=parallel)
        assert (inf.exe._mesh is not None) == parallel
        answers.append(np.asarray(inf.infer({"x": feed["x"]})[0]).tobytes())
    assert answers[0] == answers[1]
