"""The expert-parallel ``switch_moe`` and the pipeline schedules on the CPU
against the JAX package's on its 8 CPU devices (``tests/conftest.py``).

The cases of ``tests/unittests/test_moe_ep.py`` and
``test_pipeline_pp.py``: the engines called directly on seeded numpy
inputs, and the Programs (both packages build the same JSON, the port's
seeded startup state copied into both) trained under each package's
``ParallelExecutor`` or ``Trainer``.  The port's ranks are ``"cpu"``
named once a rank.  Limits, each the reference test's: the engines'
outputs within 1e-4 relative and 1e-5 absolute; losses within 2e-4
relative (1e-6 absolute); parameters within 5e-4 relative (1e-6
absolute); the Transformer stages 5e-4 and 1e-5.  Port against port:
the schedules compute the one-device pipeline op's steps, bitwise here.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import moe as JM
from paddle_tpu_torch.parallel import collective as C
from paddle_tpu_torch.parallel import moe as TM
from paddle_tpu_torch.parallel import pipeline as TP

ENGINE_RTOL, ENGINE_ATOL = 1e-4, 1e-5
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-6
PARAM_RTOL, PARAM_ATOL = 5e-4, 1e-6
S, M, D = 4, 8, 16


# -- switch_moe over ep ---------------------------------------------------

def _jexpert(p, toks):
    return jnp.tanh(toks @ p["w"]) @ p["v"]


def _texpert(p, toks):
    return torch.tanh(toks @ p["w"]) @ p["v"]


def _moe_inputs(E=8, D_=8, H=16, seed=0, tokens=64):
    rng = np.random.RandomState(seed)
    gate_w = rng.randn(D_, E).astype("float32") * 0.5
    per = [{"w": rng.randn(D_, H).astype("float32") * 0.4,
            "v": rng.randn(H, D_).astype("float32") * 0.4} for _ in range(E)]
    x = rng.randn(tokens, D_).astype("float32")
    return x, gate_w, per


def _both_moe(x, gate_w, per, cap, E=8):
    jmesh = JMesh(np.array(jax.devices()[:E]), ("ep",))
    want = np.asarray(JM.switch_moe(jnp.asarray(x), jnp.asarray(gate_w),
                                    JM.moe_expert_params(per), _jexpert,
                                    jmesh, capacity_factor=cap))
    stacked = {k: torch.tensor(v) for k, v in TM.moe_expert_params(per).items()}
    C.reset_engine_counts()
    got = TM.switch_moe(torch.tensor(x), torch.tensor(gate_w), stacked,
                        _texpert, C.make_mesh({"ep": E}, ["cpu"] * E),
                        capacity_factor=cap).numpy()
    assert C.ENGINE_RUNS["ep"] == 1
    return got, want


def test_switch_moe_matches_dense():
    x, gate_w, per = _moe_inputs(seed=0)
    got, want = _both_moe(x, gate_w, per, 64.0)  # ample: no drops
    dense = TM.switch_moe_dense_reference(x, gate_w, TM.moe_expert_params(per),
                                          _texpert)
    np.testing.assert_allclose(got, want, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    np.testing.assert_allclose(got, dense, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    assert TM.dropped_tokens(torch.tensor(x), torch.tensor(gate_w), 8, 64.0) == 0


def test_switch_moe_capacity_drops_tokens_softly():
    """At C = 1 a token past its expert's capacity gives exact zeros, the
    survivors the dense rows; the same tokens drop in both packages."""
    x, gate_w, per = _moe_inputs(seed=2)
    got, want = _both_moe(x, gate_w, per, 1e-9)  # -> C = 1
    dense = TM.switch_moe_dense_reference(x, gate_w, TM.moe_expert_params(per),
                                          _texpert)
    kept = np.abs(got).sum(1) > 0
    assert 0 < kept.sum() <= 8 * 8
    assert np.array_equal(kept, np.abs(want).sum(1) > 0)
    np.testing.assert_allclose(got[kept], dense[kept], rtol=ENGINE_RTOL,
                               atol=ENGINE_ATOL)
    assert not got[~kept].any()
    assert TM.dropped_tokens(torch.tensor(x), torch.tensor(gate_w), 8,
                             1e-9) == int((~kept).sum())


def test_switch_moe_gradients_match_the_dense_rule():
    """The gate's and the experts' gradients through the two all_to_alls
    (ample capacity) are those of the dense top-1 computation."""
    x, gate_w, per = _moe_inputs(seed=4, tokens=32)
    stacked = TM.moe_expert_params(per)

    def leaves():
        return (torch.tensor(gate_w, requires_grad=True),
                {k: torch.tensor(v, requires_grad=True)
                 for k, v in stacked.items()})

    gw, ps = leaves()
    (TM.switch_moe(torch.tensor(x), gw, ps, _texpert,
                   C.make_mesh({"ep": 8}, ["cpu"] * 8),
                   capacity_factor=64.0) ** 2).sum().backward()
    dgw, dps = leaves()
    xt = torch.tensor(x)
    probs = torch.softmax(xt @ dgw, -1)
    choice = probs.argmax(-1)
    dense = torch.stack([probs[t, e] * _texpert(
        {k: v[e] for k, v in dps.items()}, xt[t:t + 1])[0]
        for t, e in enumerate(choice.tolist())])
    (dense ** 2).sum().backward()
    assert float(gw.grad.abs().sum()) > 0
    for g, w in ((gw.grad, dgw.grad), (ps["w"].grad, dps["w"].grad),
                 (ps["v"].grad, dps["v"].grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=ENGINE_RTOL,
                                   atol=ENGINE_ATOL)


@pytest.mark.parametrize("case", ["tokens", "gate", "lead"])
def test_switch_moe_raises_the_reference_errors(case):
    x, gate_w, per = _moe_inputs(seed=1)
    stacked = TM.moe_expert_params(per)
    if case == "tokens":
        x = x[:60]
    elif case == "gate":
        gate_w = np.concatenate([gate_w, gate_w[:, :1]], 1)
    else:
        stacked = {k: v[:4] for k, v in stacked.items()}
    jmesh = JMesh(np.array(jax.devices()[:8]), ("ep",))
    with pytest.raises(ValueError) as want:
        JM.switch_moe(jnp.asarray(x), jnp.asarray(gate_w),
                      {k: jnp.asarray(v) for k, v in stacked.items()},
                      _jexpert, jmesh)
    with pytest.raises(ValueError) as got:
        TM.switch_moe(torch.tensor(x), torch.tensor(gate_w),
                      {k: torch.tensor(v) for k, v in stacked.items()},
                      _texpert, C.make_mesh({"ep": 8}, ["cpu"] * 8))
    assert str(got.value) == str(want.value)


def _moe_program(fl, cap=64.0):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[8], dtype="float32")
        o = L.switch_moe(x, num_experts=8, expert_hidden=16,
                         capacity_factor=cap)
        loss = L.mean(L.square_error_cost(input=o, label=y))
        fl.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _copy_state(tm, tscope):
    jscope = jfluid.Scope()
    for n in tm.persistable_names():
        if n in tscope and tscope[n] is not None:
            jscope[n] = np.array(tscope[n])
    return jscope


def _train(main, loss, scope, feed, steps, fl, mesh=None, devices=None,
           **pe):
    if fl is jfluid:
        with jfluid.scope_guard(scope):
            run = (jfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                           mesh_shape=mesh, **pe)
                   if mesh else None)
            exe = jfluid.Executor(jfluid.CPUPlace())
            return [float(np.ravel(run.run(fetch_list=[loss], feed=feed)[0]).mean()
                          if run else np.ravel(exe.run(main, feed=feed,
                                                       fetch_list=[loss])[0])[0])
                    for _ in range(steps)]
    if mesh:
        pexe = tfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                       mesh_shape=mesh, scope=scope,
                                       devices=devices, **pe)
        return [float(np.ravel(pexe.run(fetch_list=[loss], feed=feed)[0])[0])
                for _ in range(steps)]
    exe = tfluid.Executor(tfluid.CPUPlace())
    return [float(np.ravel(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0])[0]) for _ in range(steps)]


def _start(build, seed):
    jm, _, jloss = build(jfluid)
    tm, ts, tloss = build(tfluid)
    assert jm.to_string() == tm.to_string()
    ts.random_seed = seed
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(ts, scope=tscope)
    return jm, jloss, tm, tloss, tscope


def _params(prog, scope):
    return {p.name: np.array(scope[p.name])
            for p in prog.global_block().all_parameters()}


def test_switch_moe_layer_through_parallel_executor():
    """test_moe_ep.py::test_switch_moe_layer_through_parallel_executor:
    four SGD steps over {dp 1, ep 8} against the JAX package's, and the
    port's engine against its own one-device dense rule."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(32, 8).astype("float32"),
            "y": rng.randn(32, 8).astype("float32")}
    jm, jloss, tm, tloss, tscope = _start(_moe_program, 23)
    jscope = _copy_state(tm, tscope)
    dense_scope = _copy_state(tm, tscope)
    want = _train(jm, jloss, jscope, feed, 4, jfluid, {"dp": 1, "ep": 8})
    C.reset_engine_counts()
    got = _train(tm, tloss, tscope, feed, 4, tfluid, {"dp": 1, "ep": 8},
                 ["cpu"] * 8)
    assert C.ENGINE_RUNS["ep"] == 4
    tdense = tfluid.Scope()
    for n, v in dense_scope.vars.items():
        tdense[n] = v
    dense = _train(tm, tloss, tdense, feed, 4, tfluid)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got, dense, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert got[-1] < got[0]


# -- the pipeline schedules over pp ----------------------------------------

def _pipe_program(fl, stages=S, microbatches=M, repeats=1, minimize=True,
                  block=False):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[D], dtype="float32")
        y = L.data(name="y", shape=[D], dtype="float32")
        pipe = L.Pipeline(num_stages=stages, num_microbatches=microbatches,
                          circular_repeats=repeats)
        with pipe.stage():
            h = pipe.stage_input(x)
            if block:   # a Transformer block: fc, relu fc, residual, norm
                ff = L.fc(L.fc(h, size=D * 2, act="relu"), size=D)
                o = L.layer_norm(L.elementwise_add(h, ff))
            else:
                o = L.fc(h, size=D, act="tanh")
            pipe.stage_output(o)
        loss = L.mean(L.square_error_cost(input=pipe(), label=y))
        if minimize:
            fl.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _feed(batch=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, D).astype("float32"),
            "y": rng.randn(batch, D).astype("float32")}


PIPE_CASES = {
    # (program kwargs, mesh, batch): test_pipeline_pp_matches_sequential,
    # test_pipeline_circular_schedule_matches_sequential,
    # test_pipeline_composes_with_dp_axis, test_pipeline_transformer_block_stage
    "gpipe": (dict(), {"dp": 1, "pp": S}, 32),
    "circular": (dict(stages=4, microbatches=4, repeats=2), {"dp": 1, "pp": 2}, 16),
    "dp_x_pp": (dict(), {"dp": 2, "pp": S}, 32),
    "transformer_block": (dict(stages=2, microbatches=4, block=True),
                          {"dp": 1, "pp": 2}, 16),
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_over_pp_matches_jax_and_the_one_device_op(case):
    kw, mesh, batch = PIPE_CASES[case]
    feed = _feed(batch, seed=len(case))
    jm, jloss, tm, tloss, tscope = _start(
        lambda fl: _pipe_program(fl, **kw), 31)
    jscope = _copy_state(tm, tscope)
    one_scope = tfluid.Scope()
    for n in tm.persistable_names():
        if n in tscope:
            one_scope[n] = np.array(tscope[n])
    want = _train(jm, jloss, jscope, feed, 4, jfluid, mesh)
    C.reset_engine_counts()
    n_ranks = int(np.prod(list(mesh.values())))
    got = _train(tm, tloss, tscope, feed, 4, tfluid, mesh, ["cpu"] * n_ranks)
    engine = "circular" if kw.get("repeats", 1) > 1 else "gpipe"
    assert C.ENGINE_RUNS[engine] == 4
    one = _train(tm, tloss, one_scope, feed, 4, tfluid)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    jp, tp = _params(jm, jscope), _params(tm, tscope)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=n)
    # the schedule runs the one-device op's stage computations
    assert got == one
    onep = _params(tm, one_scope)
    assert all(tp[n].tobytes() == onep[n].tobytes() for n in tp)
    assert got[-1] < got[0]


def test_pipeline_state_lives_on_its_stages():
    """The stacked parameters are split on their stage axis over pp, as the
    JAX package's ``.sharding.spec`` is P('pp'); each rank holds its
    stage's block."""
    jm, jloss, tm, tloss, tscope = _start(_pipe_program, 31)
    jscope = _copy_state(tm, tscope)
    feed = _feed(seed=3)
    _train(jm, jloss, jscope, feed, 1, jfluid, {"dp": 1, "pp": S})
    pexe = tfluid.ParallelExecutor(loss_name=tloss.name, main_program=tm,
                                   mesh_shape={"dp": 1, "pp": S},
                                   scope=tscope, devices=["cpu"] * S)
    pexe.run(fetch_list=[tloss], feed=feed)
    specs = pexe._exe.state_specs(tscope, tm)
    for p in tm.global_block().all_parameters():
        jspec = tuple(jscope.vars[p.name].sharding.spec)
        assert specs[p.name] == ("pp",) == jspec[:1]
        blocks = tscope.vars[p.name].blocks
        assert len(blocks) == S and all(b.shape[0] == 1 for b in blocks.values())


def test_pipeline_gradients_reach_every_stage():
    """calc_gradient through the GPipe schedule: every stage's slice gets
    its gradient, the JAX package's sequential ones (test_pipeline_
    backward_grads_flow_every_stage)."""
    def build(fl):
        main, startup, loss = _pipe_program(fl, minimize=False)
        with fl.program_guard(main, startup):
            params = main.global_block().all_parameters()
            grads = fl.backward.calc_gradient(loss, params)
        return main, startup, (loss, grads)

    jm, (jl, jg), tm, (tl, tg), tscope = _start(build, 31)
    jscope = _copy_state(tm, tscope)
    feed = _feed(seed=2)
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            jm, feed=feed, fetch_list=[g.name for g in jg])
    pexe = tfluid.ParallelExecutor(main_program=tm, scope=tscope,
                                   mesh_shape={"dp": 1, "pp": S},
                                   devices=["cpu"] * S)
    got = pexe.run(fetch_list=[g.name for g in tg], feed=feed)
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.shape[0] == S and (np.abs(g).reshape(S, -1).sum(1) > 0).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


def _tf_program(n_layer, stages, microbatches, repeats):
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch.models import transformer as TT

    kw = dict(batch_size=4, seq_len=8, src_vocab_size=32, trg_vocab_size=32,
              max_length=8, n_layer=n_layer, n_head=2, d_model=16, d_inner=32,
              dropout=0.0, pipeline_stages=stages,
              pipeline_microbatches=microbatches,
              pipeline_circular_repeats=repeats)

    def build(fl):
        T = JT if fl is jfluid else TT
        with fl.unique_name.guard():
            m = T.get_model(**kw)
        return m["main"], m["startup"], m["loss"]
    return build


@pytest.mark.parametrize("n_layer,stages,mb,repeats", [(2, 2, 2, 1), (4, 4, 4, 2)])
def test_pipelined_transformer_over_pp_matches_jax(n_layer, stages, mb, repeats):
    """test_pipeline_transformer_encoder_flagship and _circular: both
    stacks pipelined, the pad biases and the encoder's output as side
    inputs, three Adam steps over {dp 1, pp 2} against the JAX package's
    within 5e-4 relative, 1e-5 absolute."""
    jm, jloss, tm, tloss, tscope = _start(
        _tf_program(n_layer, stages, mb, repeats), 77)
    jscope = _copy_state(tm, tscope)
    rng = np.random.RandomState(8 + n_layer)
    feed = {n: rng.randint(1, 32, size=(4, 8)).astype("int64")
            for n in ("src_word", "trg_word", "lbl_word")}
    want = _train(jm, jloss, jscope, feed, 3, jfluid, {"dp": 1, "pp": 2})
    got = _train(tm, tloss, tscope, feed, 3, tfluid, {"dp": 1, "pp": 2},
                 ["cpu"] * 2)
    assert np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5)


def test_pipeline_under_trainer():
    """test_pipeline_pp.py::test_pipeline_under_trainer: Trainer(parallel=
    {dp 1, pp 4}) against a one-device Trainer, step for step (the port's
    ranks named by ``devices=``): bitwise.  The two packages' Trainers draw
    their start states from different generators, so this case holds the
    port to itself, as the reference holds the JAX package to itself."""
    feed = _feed(seed=3)
    batch = list(zip(feed["x"], feed["y"]))

    def train_func(fl):
        def fn():
            L = fl.layers
            x = L.data(name="x", shape=[D], dtype="float32")
            y = L.data(name="y", shape=[D], dtype="float32")
            pipe = L.Pipeline(num_stages=S, num_microbatches=M)
            with pipe.stage():
                h = pipe.stage_input(x)
                pipe.stage_output(L.fc(h, size=D, act="tanh"))
            return L.mean(L.square_error_cost(input=pipe(), label=y))
        return fn

    def run(fl, parallel, **kw):
        np.random.seed(123)  # the startup's seed: one start state for all
        t = fl.Trainer(train_func(fl), lambda: fl.optimizer.SGD(learning_rate=0.05),
                       place=fl.CPUPlace(), parallel=parallel, **kw)
        losses = []

        def handler(e):
            if isinstance(e, fl.EndStepEvent):
                losses.append(float(np.ravel(e.metrics[0]).mean()))

        t.train(num_epochs=1, event_handler=handler,
                reader=lambda: iter([batch] * 3), feed_order=["x", "y"])
        return losses, t

    seq, _ = run(tfluid, False)
    pp, t = run(tfluid, {"dp": 1, "pp": S}, devices=["cpu"] * S)
    assert t.exe._mesh.shape == {"dp": 1, "pp": S}
    assert len(seq) == 3 and pp == seq and seq[-1] < seq[0]


def _torch_stage(p, h, side, device):
    return torch.tanh(h @ p["w"] + p["b"])


@pytest.mark.parametrize("repeats", [1, 2])
def test_the_schedules_called_directly_match_the_sequential_chain(repeats):
    """pipeline_apply (GPipe over 4 ranks) and pipeline_apply_circular
    (4 virtual stages on 2 ranks) on a tanh layer a stage: the output
    and the gradients of every stage's rows are those of the stages in
    sequence (row circular_stage_index(v) for virtual stage v), bitwise."""
    n_dev = 4 if repeats == 1 else 2
    L = n_dev * repeats
    rng = np.random.RandomState(repeats)
    params = {"w": rng.randn(L, D, D).astype("float32") * 0.3,
              "b": rng.randn(L, D).astype("float32") * 0.1}
    x = rng.randn(16, D).astype("float32")
    mesh = C.make_mesh({"pp": n_dev}, ["cpu"] * n_dev)

    def leaves():
        return {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}

    tp = leaves()
    if repeats == 1:
        got = TP.pipeline_apply(_torch_stage, tp, torch.tensor(x), mesh, 4)
    else:
        got = TP.pipeline_apply_circular(_torch_stage, tp, torch.tensor(x),
                                         mesh, 4, repeats)
    (got ** 2).sum().backward()
    sp = leaves()
    outs = []
    for mb in torch.tensor(x).chunk(4, 0):
        for v in range(L):
            i = TP.circular_stage_index(v, n_dev, repeats)
            mb = _torch_stage({k: t[i] for k, t in sp.items()}, mb, {}, None)
        outs.append(mb)
    want = torch.cat(outs, 0)
    (want ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), sp[k].grad.numpy(),
                                   rtol=ENGINE_RTOL, atol=ENGINE_ATOL)


def test_the_schedules_raise_the_reference_errors():
    mesh = C.make_mesh({"pp": 2}, ["cpu"] * 2)
    p = {"w": torch.zeros(4, D, D), "b": torch.zeros(4, D)}
    x = torch.zeros(12, D)
    with pytest.raises(ValueError, match="microbatches"):
        TP.pipeline_apply(_torch_stage, p, x, mesh, 5)
    with pytest.raises(ValueError, match="waves of the pp size"):
        TP.pipeline_apply_circular(_torch_stage, p, x, mesh, 3, 2)
    with pytest.raises(ValueError, match="S\\*repeats"):
        TP.pipeline_apply_circular(_torch_stage, p, x, mesh, 4, 3)
