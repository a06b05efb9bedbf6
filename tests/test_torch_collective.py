"""The port's collectives (``paddle_tpu_torch.parallel.collective``) on the
CPU against ``jax.lax`` under ``shard_map`` on the JAX package's 8 CPU
devices (``tests/conftest.py`` forces them).

Each collective gets one seeded numpy block a rank (the JAX side one
shard of the concatenated array a device) and its result, and its
gradient of a seeded weighting of the result, are held to the JAX
package's within RTOL/ATOL (float32 sums in another order).  Port
against port: a collective gives the same bits twice.  ``make_mesh``'s
``-1`` rule and its ``ValueError``, ``init_distributed``'s validation
and environment defaults are the JAX package's; the two-process psum
runs two gloo processes of two CPU ranks each (a global 4), as
``tests/unittests/test_distributed_init.py`` runs two JAX processes.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from paddle_tpu.parallel import collective as JC
from paddle_tpu_torch.parallel import collective as C

RTOL = 1e-6
ATOL = 1e-6
N = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blocks(shape=(4, 6), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(N)]


def _jax_run(fn, blocks, out_specs=P("x")):
    """``fn`` under shard_map over 8 devices, each device's shard one of
    ``blocks`` (concatenated on dim 0)."""
    mesh = JMesh(np.array(jax.devices()[:N]), ("x",))
    wrapped = JC.shard_map_compat(mesh=mesh, in_specs=P("x"),
                                  out_specs=out_specs, check_vma=False)(fn)
    return jax.jit(wrapped)


CASES = {
    "psum": (lambda a: jax.lax.psum(a, "x"), lambda xs: C.psum(xs)),
    "all_reduce": (lambda a: jax.lax.psum(a, "x"), lambda xs: C.all_reduce(xs)),
    "pmean": (lambda a: jax.lax.pmean(a, "x"), lambda xs: C.pmean(xs)),
    "all_gather_tiled_0": (lambda a: jax.lax.all_gather(a, "x", axis=0, tiled=True),
                           lambda xs: C.all_gather(xs, axis=0, tiled=True)),
    "all_gather_tiled_1": (lambda a: jax.lax.all_gather(a, "x", axis=1, tiled=True),
                           lambda xs: C.all_gather(xs, axis=1, tiled=True)),
    "all_gather_stacked": (lambda a: jax.lax.all_gather(a, "x", axis=0, tiled=False),
                           lambda xs: C.all_gather(xs, axis=0, tiled=False)),
    "reduce_scatter_0": (lambda a: jax.lax.psum_scatter(
        jnp.tile(a, (2, 1)), "x", scatter_dimension=0, tiled=True),
        lambda xs: C.reduce_scatter([x.repeat(2, 1) for x in xs], 0)),
    "reduce_scatter_1": (lambda a: jax.lax.psum_scatter(
        jnp.tile(a, (1, 4)), "x", scatter_dimension=1, tiled=True),
        lambda xs: C.reduce_scatter([x.repeat(1, 4) for x in xs], 1)),
    "ppermute_ring": (lambda a: jax.lax.ppermute(a, "x", [(i, (i + 1) % N) for i in range(N)]),
                      lambda xs: C.ppermute(xs, [(i, (i + 1) % N) for i in range(N)])),
    "ppermute_partial": (lambda a: jax.lax.ppermute(a, "x", [(0, 3), (5, 1)]),
                         lambda xs: C.ppermute(xs, [(0, 3), (5, 1)])),
    "all_to_all_0_1": (lambda a: jax.lax.all_to_all(
        jnp.tile(a, (2, 1)), "x", 0, 1, tiled=True),
        lambda xs: C.all_to_all([x.repeat(2, 1) for x in xs], 0, 1)),
    "all_to_all_1_0": (lambda a: jax.lax.all_to_all(
        jnp.tile(a, (1, 4)), "x", 1, 0, tiled=True),
        lambda xs: C.all_to_all([x.repeat(1, 4) for x in xs], 1, 0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_collective_and_its_gradient_match_jax(name):
    jfn, tfn = CASES[name]
    blocks = _blocks(seed=len(name))
    run = _jax_run(jfn, blocks)
    want = np.asarray(run(jnp.asarray(np.concatenate(blocks, 0))))
    xs = [torch.tensor(b, requires_grad=True) for b in blocks]
    outs = tfn(xs)
    got = torch.cat(outs, 0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)

    rng = np.random.RandomState(99)
    w = rng.randn(*want.shape).astype(np.float32)
    jgrad = np.asarray(jax.grad(lambda a: (run(a) * w).sum())(
        jnp.asarray(np.concatenate(blocks, 0))))
    (got * torch.tensor(w)).sum().backward()
    # a rank whose tensor no pair sends has no gradient: zeros in JAX
    tgrad = np.concatenate([(x.grad if x.grad is not None
                             else torch.zeros_like(x)).numpy() for x in xs], 0)
    np.testing.assert_allclose(tgrad, jgrad, rtol=RTOL, atol=ATOL)


def test_each_rank_gets_a_tensor_on_its_device():
    xs = [torch.ones(2) * i for i in range(4)]
    outs = C.psum(xs, devices=["cpu"] * 4)
    assert len(outs) == 4 and all(o.device.type == "cpu" for o in outs)
    assert all(o.tolist() == [6.0, 6.0] for o in outs)


@pytest.mark.parametrize("name", ["psum", "pmean", "reduce_scatter_0"])
def test_a_collective_gives_the_same_bits_twice(name):
    _, tfn = CASES[name]
    xs = [torch.tensor(b) for b in _blocks(seed=7)]
    a = torch.cat(tfn(xs), 0)
    b = torch.cat(tfn(xs), 0)
    assert a.numpy().tobytes() == b.numpy().tobytes()


def test_collectives_reject_what_does_not_split():
    xs = [torch.ones(3, 2) for _ in range(2)]
    with pytest.raises(ValueError, match="does not split"):
        C.reduce_scatter([torch.ones(3, 2)] * 4, 0)
    with pytest.raises(ValueError, match="does not split"):
        C.all_to_all(xs * 2, 0, 1)
    with pytest.raises(ValueError, match="receives twice"):
        C.ppermute(xs, [(0, 1), (1, 1)])


@pytest.mark.parametrize("axes,n", [({"dp": -1}, 8), ({"dp": 2, "tp": -1}, 8),
                                    ({"dp": 4, "tp": 2}, 8), ({"sp": 4}, 8)])
def test_make_mesh_follows_the_reference(axes, n):
    want = JC.make_mesh(axes, jax.devices()[:n])
    got = C.make_mesh(axes, ["cpu"] * n)
    assert got.axis_names == want.axis_names
    assert got.devices.shape == want.devices.shape
    assert got.shape == dict(zip(want.axis_names, want.devices.shape))
    for name in got.axis_names:
        assert C.axis_size(got, name) == got.shape[name]
    last = got.size - 1
    assert [C.axis_index(got, a, last) for a in got.axis_names] == [
        s - 1 for s in got.devices.shape]


def test_make_mesh_raises_the_reference_value_error():
    with pytest.raises(ValueError) as want:
        JC.make_mesh({"dp": 4}, jax.devices()[:2])
    with pytest.raises(ValueError) as got:
        C.make_mesh({"dp": 4}, ["cpu"] * 2)
    assert str(got.value) == str(want.value)


def test_mesh_groups_follow_the_axes():
    mesh = C.make_mesh({"dp": 2, "tp": 2}, ["cpu"] * 4)
    assert mesh.groups("tp") == [[0, 1], [2, 3]]
    assert mesh.groups("dp") == [[0, 2], [1, 3]]
    assert mesh.coords(3) == (1, 1) and mesh.rank((1, 0)) == 2


def test_validation(monkeypatch):
    """tests/unittests/test_distributed_init.py::test_validation."""
    monkeypatch.delenv("PADDLE_COORDINATOR", raising=False)
    for mod in (JC, C):
        with pytest.raises(ValueError, match="out of range"):
            mod.init_distributed(num_processes=2, process_id=5)
        with pytest.raises(ValueError, match="coordinator_address"):
            mod.init_distributed(num_processes=2, process_id=0)
        mod.init_distributed()  # one process, no coordinator: a no-op
    assert not torch.distributed.is_initialized()
    C.shutdown_distributed()  # never initialized: a no-op


def test_env_defaults(monkeypatch):
    monkeypatch.delenv("PADDLE_COORDINATOR", raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "9")
    for mod in (JC, C):
        with pytest.raises(ValueError, match="out of range"):
            mod.init_distributed()  # id 9 of 4: env values were read


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _python(code, *args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PADDLE_")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)] + list(args),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def test_single_process_lifecycle():
    port = _free_port()
    p = _python("""
        import torch
        from paddle_tpu_torch.parallel import collective as C
        C.init_distributed('localhost:%d', 1, 0)
        C.init_distributed('localhost:%d', 1, 0)   # repeat: a no-op
        assert torch.distributed.get_world_size() == 1
        C.shutdown_distributed()
        C.shutdown_distributed()
        assert not torch.distributed.is_initialized()
        print('LIFECYCLE-OK')
        """ % (port, port))
    try:
        out, err = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, err[-2000:]
    assert "LIFECYCLE-OK" in out


def test_two_process_psum_over_localhost():
    """Two gloo processes, each with 2 CPU ranks: a psum over the global 4
    ranks reduces in the process first, then across the processes, and its
    gradient is the same psum (tests/unittests/test_distributed_init.py::
    test_two_process_psum_over_localhost)."""
    port = _free_port()
    worker = """
        import sys
        import torch
        from paddle_tpu_torch.parallel import collective as C
        me = int(sys.argv[1])
        C.init_distributed('localhost:%d', 2, me)
        xs = [torch.arange(2.0, requires_grad=True) + 2 * (2 * me + i)
              for i in range(2)]
        xs = [x.detach().requires_grad_(True) for x in xs]
        outs = C.psum(xs)
        want = sum(torch.arange(2.0) + 2 * r for r in range(4))
        assert all(torch.equal(o, want) for o in outs), outs
        sum(o.sum() for o in outs).backward()
        assert all(torch.equal(x.grad, torch.full((2,), 4.0)) for x in xs)
        assert C.pmean(xs)[0].tolist() == (want / 4).tolist()
        C.shutdown_distributed()
        print('WORKER-OK')
        """ % port
    procs = [_python(worker, str(i)) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:  # a timed-out peer must not keep the port bound
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert "WORKER-OK" in out
