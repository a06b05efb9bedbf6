"""The port's ``switch_moe`` rule and ``parallel.moe`` helpers, and
``parallel.microbatch.program_to_microbatched_fn``, against the JAX
package's, on the CPU.

The single-device cases of ``tests/unittests/test_moe_ep.py`` and
``test_microbatch.py``, at their sizes: 8 experts, width 8, hidden 16,
32-64 tokens; a 6 -> 8 -> 1 regression at batch 32 in 4 microbatches.
Both packages build the same Programs (the same ``to_string()`` JSON)
and take the same seeded numpy parameters and feeds.  Limits:
- the dense top-1 outputs and their gradients within MOE_TOL of each
  tensor's largest magnitude of the JAX package's dense branch, and of
  its expert-parallel engine on its 8-device CPU mesh (ample capacity:
  no token dropped), whose losses the reference test holds to rtol 2e-4;
- microbatched losses within LOSS_RTOL of the full-batch step's, the
  state after them within the reference test's rtol 1e-5, atol 1e-6;
  against the JAX package's microbatched function, the same.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import moe as JMOE
from paddle_tpu_torch.parallel import moe as TMOE

E, D, H = 8, 8, 16
MOE_TOL = 1e-5
LOSS_RTOL = 1e-5


def _within(got, want, tol):
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) / scale <= tol


def _experts(seed):
    rng = np.random.RandomState(seed)
    gate_w = rng.randn(D, E).astype("float32") * 0.5
    per_expert = [{"w": rng.randn(D, H).astype("float32") * 0.4,
                   "v": rng.randn(H, D).astype("float32") * 0.4}
                  for _ in range(E)]
    return gate_w, per_expert


def test_dense_reference_and_stacking_match_jax():
    import jax.numpy as jnp

    gate_w, per_expert = _experts(0)
    jstacked = JMOE.moe_expert_params(per_expert)
    tstacked = TMOE.moe_expert_params(per_expert)
    assert sorted(tstacked) == sorted(jstacked)
    for k in jstacked:
        assert np.asarray(tstacked[k]).tobytes() == np.asarray(jstacked[k]).tobytes()
    x = np.random.RandomState(1).randn(64, D).astype("float32")
    want = JMOE.switch_moe_dense_reference(
        x, gate_w, jstacked, lambda p, t: jnp.tanh(t @ p["w"]) @ p["v"])
    got = TMOE.switch_moe_dense_reference(
        x, gate_w, tstacked, lambda p, t: torch.tanh(t @ p["w"]) @ p["v"])
    assert got.shape == want.shape and _within(got, want, MOE_TOL)


def _moe_program(fl, cap=2.0, lead=()):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=list(lead) + [D], dtype="float32")
        x.stop_gradient = False
        y = L.data(name="y", shape=list(lead) + [D], dtype="float32")
        o = L.switch_moe(x, num_experts=E, expert_hidden=H,
                         capacity_factor=cap)
        loss = L.mean(L.square_error_cost(input=o, label=y))
        params = main.global_block().all_parameters()
        grads = fl.backward.calc_gradient(loss, params + [x])
    return main, startup, [o.name, loss.name] + [g.name for g in grads], \
        [p.name for p in params]


def _state(names, seed):
    gate_w, per_expert = _experts(seed)
    stacked = TMOE.moe_expert_params(per_expert)
    return dict(zip(names, (gate_w, stacked["w"], stacked["v"])))


@pytest.mark.parametrize("lead", [(), (4,)])
def test_switch_moe_rule_matches_jax_and_the_dense_reference(lead):
    """The op on [B, D] and [B, T, D] inputs: outputs, the loss and the
    gradients of the gate, both expert stacks and the input against the
    JAX package's dense branch; the output against the port's per-token
    dense reference."""
    jm, js, fetch, names = _moe_program(jfluid, lead=lead)
    tm, ts, tfetch, _ = _moe_program(tfluid, lead=lead)
    assert jm.to_string() == tm.to_string() and fetch == tfetch
    state = _state(names, 2)
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(*((16,) + lead + (D,))).astype("float32"),
            "y": rng.randn(*((16,) + lead + (D,))).astype("float32")}
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    for n, v in state.items():
        jscope[n] = v
    tfluid.load_numpy_state(tm, state, scope=tscope, device="cpu")
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(jm, feed=feed,
                                                      fetch_list=fetch)
    got = tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=tscope)
    for w, g in zip(want, got):
        assert np.asarray(g).shape == np.asarray(w).shape
        assert _within(g, w, MOE_TOL)
    dense = TMOE.switch_moe_dense_reference(
        feed["x"].reshape(-1, D), state[names[0]],
        {"w1": state[names[1]], "w2": state[names[2]]},
        lambda p, t: torch.relu(t @ p["w1"]) @ p["w2"])
    assert _within(np.asarray(got[0]).reshape(-1, D), dense, MOE_TOL)


def test_every_chosen_expert_gets_a_gradient():
    """A gradient reaches the experts the gate chose, and only them."""
    _, _, fetch, names = _moe_program(tfluid)
    tm, ts, _, _ = _moe_program(tfluid)
    state = _state(names, 4)
    x = np.random.RandomState(5).randn(6, D).astype("float32")
    scope = tfluid.Scope()
    tfluid.load_numpy_state(tm, state, scope=scope, device="cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed={"x": x, "y": np.zeros_like(x)}, fetch_list=fetch,
        scope=scope)
    chosen = set((x @ state[names[0]]).argmax(-1).tolist())
    g_gate, g_w1, g_w2 = (np.asarray(g) for g in got[2:5])
    assert np.isfinite(g_gate).all() and np.abs(g_gate).sum() > 0
    for g in (g_w1, g_w2):
        hit = {e for e in range(E) if np.abs(g[e]).sum() > 0}
        assert hit == chosen, (hit, chosen)
    assert 0 < len(chosen) < E


def test_switch_moe_trains_like_the_jax_expert_parallel_engine():
    """The reference test's Program (capacity 64: no token dropped) for 4
    SGD steps: the port on one device against the JAX package's
    ParallelExecutor on its {dp 1, ep 8} CPU mesh (the all-to-all
    engine) and against its single device."""
    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            x = L.data(name="x", shape=[D], dtype="float32")
            y = L.data(name="y", shape=[D], dtype="float32")
            o = L.switch_moe(x, num_experts=E, expert_hidden=H,
                             capacity_factor=64.0)
            loss = L.mean(L.square_error_cost(input=o, label=y))
            fl.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return main, startup, loss.name

    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(32, D).astype("float32"),
            "y": rng.randn(32, D).astype("float32")}
    tm, ts, loss = build(tfluid)
    ts.random_seed = 23
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(ts, scope=tscope)
    state = {n: np.array(tscope[n]) for n in tm.persistable_names()
             if n in tscope}
    got = [float(np.ravel(texe.run(tm, feed=feed, fetch_list=[loss],
                                   scope=tscope)[0])[0]) for _ in range(4)]
    runs = {}
    for mesh in (None, {"dp": 1, "ep": E}):
        jm, _, jloss = build(jfluid)
        assert jm.to_string() == tm.to_string()
        jscope = jfluid.Scope()
        for n, v in state.items():
            jscope[n] = v
        with jfluid.scope_guard(jscope):
            if mesh:
                pexe = jfluid.ParallelExecutor(loss_name=jloss, main_program=jm,
                                               mesh_shape=mesh)
                run = lambda: pexe.run(fetch_list=[jloss], feed=feed)  # noqa: E731
            else:
                exe = jfluid.Executor(jfluid.CPUPlace())
                run = lambda: exe.run(jm, feed=feed, fetch_list=[jloss])  # noqa: E731
            runs[bool(mesh)] = [float(np.ravel(run()[0]).mean())
                                for _ in range(4)]
    np.testing.assert_allclose(got, runs[False], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, runs[True], rtol=2e-4, atol=1e-6)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# microbatching (test_microbatch.py)
# ---------------------------------------------------------------------------


def _regression(fl):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[6], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(input=x, size=8, act="tanh")
        p = L.fc(input=h, size=1)
        loss = L.mean(L.square_error_cost(input=p, label=y))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feeds(batch=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, 6).astype("float32"),
            "y": rng.randn(batch, 1).astype("float32")}


@pytest.mark.parametrize("k", [1, 4])
def test_microbatched_step_matches_the_full_batch_and_jax(k):
    import jax

    from paddle_tpu.jax_bridge import program_to_fn as j_program_to_fn
    from paddle_tpu.parallel.microbatch import (
        program_to_microbatched_fn as j_microbatched)
    from paddle_tpu_torch.parallel.microbatch import program_to_microbatched_fn
    from paddle_tpu_torch.program_fn import init_state, program_to_fn

    main, startup, loss = _regression(tfluid)
    jmain, _, jloss = _regression(jfluid)
    assert jmain.to_string() == main.to_string()
    startup.random_seed = 11
    state = {n: v.numpy() for n, v in init_state(startup, device="cpu").items()}
    feeds = _feeds()
    (full_loss,), full_state = program_to_fn(
        main, [loss], return_state=True, device="cpu")(dict(state), feeds)
    mb_losses, mb_state = program_to_microbatched_fn(
        main, [loss], num_microbatches=k, device="cpu")(dict(state), feeds)
    assert tuple(mb_losses[0].shape) == (k, 1)
    np.testing.assert_allclose(float(mb_losses[0].mean()),
                               float(full_loss.reshape(-1)[0]),
                               rtol=LOSS_RTOL)
    assert sorted(mb_state) == sorted(full_state)
    for n in full_state:
        np.testing.assert_allclose(mb_state[n].numpy(),
                                   full_state[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    # the JAX package's microbatched function from the same state
    j_losses, j_state = j_microbatched(jmain, [jloss], num_microbatches=k)(
        dict(state), feeds, jax.random.PRNGKey(1))
    np.testing.assert_allclose(mb_losses[0].numpy(), np.asarray(j_losses[0]),
                               rtol=LOSS_RTOL)
    for n in j_state:
        np.testing.assert_allclose(mb_state[n].numpy(), np.asarray(j_state[n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    (j_full,), _ = j_program_to_fn(jmain, [jloss], return_state=True)(
        dict(state), feeds, jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(full_loss.reshape(-1)[0]),
                               float(np.ravel(j_full)[0]), rtol=LOSS_RTOL)


def test_microbatching_checks_its_inputs():
    from paddle_tpu_torch.parallel.microbatch import program_to_microbatched_fn
    from paddle_tpu_torch.program_fn import init_state

    main, startup, loss = _regression(tfluid)
    state = init_state(startup, device="cpu")
    fn = program_to_microbatched_fn(main, [loss], num_microbatches=3,
                                    device="cpu")
    with pytest.raises(ValueError, match="not divisible by 3"):
        fn(dict(state), _feeds())
    fwd = main.clone(for_test=True)
    with pytest.raises(ValueError, match="no backward op"):
        program_to_microbatched_fn(fwd, [loss], 2, device="cpu")


def test_a_learning_rate_schedule_reaches_the_optimizer_r9():
    """R-9: the optimizer reads a learning rate the forward computes (an
    exponential decay, 0.1 * 0.5 ** (step / 100)).  The JAX package's
    microbatched function raises KeyError on it; the port's hands the
    optimizer the last microbatch's rate.  The step counter counts each
    microbatch, as the reference's scan threads it, so the rate is one
    decay step on (0.5 ** 0.01 of the full-batch step's) and the update,
    the averaged gradient times the rate, is the full-batch step's times
    that factor."""
    import jax

    from paddle_tpu.parallel.microbatch import (
        program_to_microbatched_fn as j_microbatched)
    from paddle_tpu_torch.parallel.microbatch import program_to_microbatched_fn
    from paddle_tpu_torch.program_fn import init_state, program_to_fn

    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            x = L.data(name="x", shape=[6], dtype="float32")
            y = L.data(name="y", shape=[1], dtype="float32")
            p = L.fc(input=L.fc(input=x, size=8, act="tanh"), size=1)
            loss = L.mean(L.square_error_cost(input=p, label=y))
            lr = L.exponential_decay(learning_rate=0.1, decay_steps=100,
                                     decay_rate=0.5)
            fl.optimizer.SGD(learning_rate=lr).minimize(loss)
        return main, startup, loss

    main, startup, loss = build(tfluid)
    jmain, _, jloss = build(jfluid)
    assert jmain.to_string() == main.to_string()
    startup.random_seed = 13
    state = {n: v.numpy() for n, v in init_state(startup, device="cpu").items()}
    feeds = _feeds(seed=2)
    with pytest.raises(KeyError):
        j_microbatched(jmain, [jloss], num_microbatches=2)(
            dict(state), feeds, jax.random.PRNGKey(0))
    _, full = program_to_fn(main, [loss], return_state=True,
                            device="cpu")(dict(state), feeds)
    _, micro = program_to_microbatched_fn(main, [loss], 2, device="cpu")(
        dict(state), feeds)
    params = [p.name for p in main.global_block().all_parameters()]
    for n in params:
        np.testing.assert_allclose(state[n] - micro[n].numpy(),
                                   (state[n] - full[n].numpy()) * 0.5 ** 0.01,
                                   rtol=1e-4, atol=1e-7, err_msg=n)
    # the step counter counted both microbatches, as the reference's scan
    counter = [n for n in full if "counter" in n.lower()]
    assert counter and all(float(micro[n].reshape(-1)[0])
                           == float(full[n].reshape(-1)[0]) + 1
                           for n in counter)
