"""Sequence parallelism on the CPU: the port's ring and Ulysses attention
and the ``flash_attention`` rule's ``sp`` branch against the JAX
package's on its 8 CPU devices (``tests/conftest.py``).

The cases of ``tests/unittests/test_flash_ring_attention.py`` (its ring
cases), ``test_ulysses_attention.py`` and ``test_parallel_executor.py``'s
sp cases, each on the same seeded inputs, with the reference test's
limits: outputs within 2e-4 (rtol and atol), gradients within 2e-3, the
Programs' outputs and the sp Transformer's losses within 2e-4 relative.
The port's ranks are ``["cpu"] * 8`` (a mesh may name a device more than
once); its engine counters show which path ran.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import collective as JC
from paddle_tpu.parallel.flash_attention import mha_reference as jmha
from paddle_tpu.parallel.ring_attention import ring_attention_sharded as jring
from paddle_tpu.parallel.ulysses import ulysses_attention_sharded as julysses
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel.ring_attention import ring_attention_sharded
from paddle_tpu_torch.parallel.ulysses import ulysses_attention_sharded

OUT_TOL = 2e-4
GRAD_TOL = 2e-3
CPU8 = ["cpu"] * 8


def _qkv(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


def _engines(shape):
    return C.make_mesh(shape, ["cpu"] * int(np.prod(list(shape.values()))))


@pytest.mark.parametrize("engine", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_engine_matches_jax_and_full_attention(engine, causal):
    q, k, v = _qkv(1, 8, 64, 16, seed=3)
    jrun, trun = ((jring, ring_attention_sharded) if engine == "ring"
                  else (julysses, ulysses_attention_sharded))
    want = np.asarray(jrun(*map(jnp.asarray, (q, k, v)),
                           JC.make_mesh({"sp": 8}), causal=causal))
    full = np.asarray(jmha(*map(jnp.asarray, (q, k, v)), causal=causal))
    C.reset_engine_counts()
    got = trun(*map(torch.tensor, (q, k, v)), _engines({"sp": 8}),
               causal=causal).numpy()
    assert C.ENGINE_RUNS[engine] == 1
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(got, full, rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("engine", ["ring", "ulysses"])
def test_engine_gradients_match_jax(engine):
    """d/d(q, k, v) of sum(o ** 2) over 4 ranks against the JAX package's
    full attention (test_ring_attention_grad, test_ulysses_grads_match)."""
    q, k, v = _qkv(1, 4, 32, 8, seed=4)
    trun = ring_attention_sharded if engine == "ring" else ulysses_attention_sharded
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (trun(*ts, _engines({"sp": 4})) ** 2).sum().backward()
    want = jax.grad(lambda a, b, c: (jmha(a, b, c) ** 2).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_ulysses_rejects_indivisible_heads():
    q, k, v = _qkv(1, 4, 64, 16, seed=0)
    with pytest.raises(ValueError) as want:
        julysses(*map(jnp.asarray, (q, k, v)), JC.make_mesh({"sp": 8}))
    with pytest.raises(ValueError) as got:
        ulysses_attention_sharded(*map(torch.tensor, (q, k, v)),
                                  _engines({"sp": 8}))
    assert str(got.value) == str(want.value)


def _attention_program(fl, n_head, sp_engine, causal=True, lens=False,
                       T=16, sequence_parallel=True):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        q, k, v = (L.data(name=n, shape=[n_head, T, 8], dtype="float32")
                   for n in ("q", "k", "v"))
        kv_lens = (L.data(name="lens", shape=[1], dtype="int32")
                   if lens else None)
        o = L.flash_attention(q, k, v, kv_lens=kv_lens, causal=causal,
                              sequence_parallel=sequence_parallel,
                              sp_engine=sp_engine)
        s = L.reduce_sum(o)
    return main, s, o


def _feed(n_head, T=16, lens=False):
    rng = np.random.RandomState(5)
    feed = {n: rng.randn(4, n_head, T, 8).astype("float32") for n in "qkv"}
    if lens:
        feed["lens"] = np.array([[T], [T - 3], [5], [T]], np.int32)
    return feed


def _both(n_head, sp_engine, mesh, **kw):
    """The Program's sum and output through the JAX package's
    ParallelExecutor over ``mesh`` and the port's over ``mesh`` of
    ``["cpu"] * 8``; the port's engine runs."""
    feed = _feed(n_head, kw.get("T", 16), kw.get("lens", False))
    jm, js, jo = _attention_program(jfluid, n_head, sp_engine, **kw)
    tm, ts, to = _attention_program(tfluid, n_head, sp_engine, **kw)
    assert jm.to_string() == tm.to_string()
    with jfluid.scope_guard(jfluid.Scope()):
        jpe = jfluid.ParallelExecutor(main_program=jm, mesh_shape=mesh)
        want = jpe.run(fetch_list=[js, jo], feed=feed)
    C.reset_engine_counts()
    tpe = tfluid.ParallelExecutor(main_program=tm, mesh_shape=mesh,
                                  scope=tfluid.Scope(), devices=CPU8)
    got = tpe.run(fetch_list=[ts, to], feed=feed)
    return got, want, dict(C.ENGINE_RUNS)


@pytest.mark.parametrize("n_head,sp_engine,ran", [
    (2, "ring", "ring"), (8, "auto", "ulysses"), (8, "ulysses", "ulysses"),
    (2, "auto", "ring")])
def test_parallel_executor_sp_attention_matches_jax(n_head, sp_engine, ran):
    """test_parallel_executor.py::test_parallel_executor_sp_attention_
    matches_single_device: the rule takes Ulysses when the heads divide
    (auto), else ring."""
    got, want, runs = _both(n_head, sp_engine, {"dp": 1, "sp": 8})
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.ravel(g), np.ravel(w), rtol=OUT_TOL,
                                   atol=1e-4)
    assert runs[ran] == 1 and runs["sp_fallback"] == 0
    assert sum(runs.values()) == 1


@pytest.mark.parametrize("kw", [dict(lens=True), dict(T=12),
                                dict(sequence_parallel=False)])
def test_the_rule_falls_back_to_the_one_shard_kernels(kw):
    """KVLens, or a sequence the axis does not divide, gathers the
    sequence and runs the one-shard kernels, as the JAX package falls
    back; sequence_parallel=False never takes an engine."""
    got, want, runs = _both(8, "auto", {"dp": 1, "sp": 8}, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.ravel(g), np.ravel(w), rtol=OUT_TOL,
                                   atol=1e-4)
    assert runs["ring"] == runs["ulysses"] == 0
    assert runs["sp_fallback"] == (0 if "sequence_parallel" in kw else 1)


def test_sp_transformer_matches_jax():
    """test_parallel_executor.py::test_parallel_executor_sp_transformer_
    matches_single_device: the Transformer with use_flash over dp 1 x sp
    8, three Adam steps, each loss within 2e-4 of the JAX package's (every
    attention carries KVLens, so every one takes the fallback, in both
    packages)."""
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch.models import transformer as TT

    B, S = 4, 16
    kw = dict(batch_size=B, seq_len=S, src_vocab_size=64, trg_vocab_size=64,
              max_length=S + 2, n_layer=1, n_head=2, d_model=16, d_inner=32,
              dropout=0.0, use_flash=True)
    rng = np.random.RandomState(4)
    feed = {n: rng.randint(4, 64, size=(B, S)).astype("int64")
            for n in ("src_word", "trg_word", "lbl_word")}
    with jfluid.unique_name.guard():
        jm = JT.get_model(**kw)
    with tfluid.unique_name.guard():
        tm = TT.get_model(**kw)
    assert jm["main"].to_string() == tm["main"].to_string()
    tm["startup"].random_seed = 17
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(tm["startup"], scope=tscope)
    jscope = jfluid.Scope()
    for n in tm["main"].persistable_names():
        if n in tscope and tscope[n] is not None:
            jscope[n] = np.array(tscope[n])
    mesh = {"dp": 1, "sp": 8}
    with jfluid.scope_guard(jscope):
        jpe = jfluid.ParallelExecutor(loss_name=jm["loss"].name,
                                      main_program=jm["main"], mesh_shape=mesh)
        want = [float(np.ravel(jpe.run(fetch_list=[jm["loss"]], feed=feed)[0]).mean())
                for _ in range(3)]
    C.reset_engine_counts()
    tpe = tfluid.ParallelExecutor(loss_name=tm["loss"].name,
                                  main_program=tm["main"], mesh_shape=mesh,
                                  scope=tscope, devices=CPU8)
    got = [float(np.ravel(tpe.run(fetch_list=[tm["loss"]], feed=feed)[0])[0])
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=1e-6)
    assert C.ENGINE_RUNS["sp_fallback"] == 3 * 3  # three attentions a step
