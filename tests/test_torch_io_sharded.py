"""The port's sharded checkpoints (``paddle_tpu_torch.io_sharded``) on the
CPU: the cases of ``tests/unittests/test_io_sharded.py``.

The JAX package writes Orbax directories and the port ``torch.save``
files beside a JSON manifest; neither reads the other's, so these cases
hold the port's round trips to the values and layouts saved, bitwise,
and the ZeRO resume to the JAX package's unbroken run within the
reference test's 2e-4 relative (1e-6 absolute), with the port's own
unbroken run bitwise.
"""
from __future__ import annotations

import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io_sharded as IO
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel.sharded import ShardedTensor, layout_spec


def _mesh(axes):
    return C.make_mesh(axes, ["cpu"] * int(np.prod(list(axes.values()))))


def test_save_restore_roundtrip_with_layouts(tmp_path):
    mesh = _mesh({"dp": 2, "tp": 2})
    w = ShardedTensor.from_full(torch.arange(64.0).reshape(8, 8), mesh,
                                (None, "tp"))
    state = {"fc.w": w, "fc.b": torch.ones(8)}
    path = IO.save_sharded(str(tmp_path), state, step=7)
    assert IO.latest_step(str(tmp_path)) == 7
    # each block once, in the file of the first rank that holds it
    assert sorted(os.listdir(path)) == ["manifest.json", "rank_0.pt", "rank_1.pt"]
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert manifest["fc.w"]["spec"] == [None, "tp"]
    assert manifest["fc.w"]["blocks"] == {"0,0": 0, "0,1": 1}
    got = IO.load_sharded(str(tmp_path), template=state)
    assert isinstance(got["fc.w"], ShardedTensor) and got["fc.w"].spec == (None, "tp")
    assert torch.equal(got["fc.w"].full(), w.full())
    assert torch.equal(got["fc.b"], state["fc.b"])


def test_latest_step_resolution_and_host_load(tmp_path):
    mesh = _mesh({"tp": 2})
    for step, k in ((1, 1.0), (3, 2.0)):
        IO.save_sharded(str(tmp_path), {"a": ShardedTensor.from_full(
            torch.arange(4.0) * k, mesh, ("tp",))}, step=step)
    got = IO.load_sharded(str(tmp_path))  # the latest, host tensors
    assert isinstance(got["a"], torch.Tensor)
    assert got["a"].tolist() == (np.arange(4.0) * 2).tolist()
    assert IO.load_sharded(str(tmp_path), step=1)["a"].tolist() == [0, 1, 2, 3]


def test_overwrite_same_step(tmp_path):
    IO.save_sharded(str(tmp_path), {"x": np.arange(3.0)}, step=0)
    IO.save_sharded(str(tmp_path), {"x": np.arange(3.0) + 5}, step=0)
    assert IO.load_sharded(str(tmp_path), step=0)["x"].tolist() == [5, 6, 7]


def test_pp_stacked_state_roundtrip(tmp_path):
    mesh = _mesh({"pp": 4})
    w = ShardedTensor.from_full(torch.arange(36.0).reshape(4, 3, 3), mesh, ("pp",))
    mom = ShardedTensor.from_full(torch.full((4, 3, 3), 0.5), mesh, ("pp",))
    state = {"pipe.w": w, "pipe.w_moment_0": mom}
    IO.save_sharded(str(tmp_path), state, step=2)
    got = IO.load_sharded(str(tmp_path), template=state)
    for k in state:
        assert layout_spec(got[k]) == ("pp",) and len(got[k].blocks) == 4
        assert torch.equal(got[k].full(), state[k].full())


def test_a_torn_step_is_skipped(tmp_path):
    """A step whose manifest never landed (a crash mid-save) is skipped
    with a warning; fallback=False and an explicit step raise."""
    IO.save_sharded(str(tmp_path), {"x": np.arange(2.0)}, step=1)
    path = IO.save_sharded(str(tmp_path), {"x": np.arange(2.0) + 9}, step=2)
    os.remove(os.path.join(path, "manifest.json"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = IO.load_sharded(str(tmp_path))
    assert got["x"].tolist() == [0, 1]
    assert any("step 2" in str(w.message) for w in caught)
    with pytest.raises(OSError):
        IO.load_sharded(str(tmp_path), fallback=False)
    with pytest.raises(OSError):
        IO.load_sharded(str(tmp_path), step=2)


def _zero_program(fl):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(input=x, size=16, act="relu")
        loss = L.mean(L.square_error_cost(input=L.fc(input=h, size=1), label=y))
        fl.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def test_zero_training_checkpoint_resume(tmp_path):
    """test_io_sharded.py::test_zero_training_checkpoint_resume: two steps
    under ZeRO 3 at dp 4, the scope saved with its layouts, restored as
    host tensors into a fresh scope, two more steps: the four losses are
    the unbroken run's, bitwise, and the JAX package's unbroken run's
    within 2e-4."""
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(32, 8).astype("float32"),
            "y": rng.randn(32, 1).astype("float32")}
    main, startup, loss = _zero_program(tfluid)
    startup.random_seed = 9
    s0 = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=s0)
    state = {n: np.array(s0[n]) for n in main.persistable_names()}

    def pexe(scope):
        return tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                       scope=scope, mesh_shape={"dp": 4},
                                       zero_stage=3, devices=["cpu"] * 4)

    def scope_of(values):
        s = tfluid.Scope()
        for n, v in values.items():
            s[n] = v
        return s

    def steps(pe, n):
        return [float(np.ravel(pe.run(fetch_list=[loss], feed=feed)[0])[0])
                for _ in range(n)]

    ref = steps(pexe(scope_of(state)), 4)
    first_scope = scope_of(state)
    first = steps(pexe(first_scope), 2)
    snap = {n: first_scope.vars[n] for n in main.persistable_names()}
    assert any("_moment" in n and isinstance(v, ShardedTensor) and "dp" in v.spec
               for n, v in snap.items())
    IO.save_sharded(str(tmp_path), snap, step=2)
    rest = steps(pexe(scope_of(IO.load_sharded(str(tmp_path), step=2))), 2)
    assert first + rest == ref

    jm, _, jloss = _zero_program(jfluid)
    assert jm.to_string() == main.to_string()
    js = jfluid.Scope()
    for n, v in state.items():
        js[n] = v
    with jfluid.scope_guard(js):
        jpe = jfluid.ParallelExecutor(loss_name=jloss.name, main_program=jm,
                                      mesh_shape={"dp": 4}, zero_stage=3)
        want = [float(np.ravel(jpe.run(fetch_list=[jloss], feed=feed)[0]).mean())
                for _ in range(4)]
    np.testing.assert_allclose(ref, want, rtol=2e-4, atol=1e-6)


def test_retry_policy_is_the_references():
    from paddle_tpu import resilience as jres
    from paddle_tpu_torch import resilience as tres

    p = IO.SHARDED_IO_POLICY
    assert (p.max_retries, p.base_delay, p.max_delay) == (2, 0.1, 1.0)
    assert p.classify is tres.is_transient_io_error
    err = OSError(5, "Input/output error")
    assert p.classify(err) == jres.is_transient_io_error(err)
