"""``Program.enable_recompute`` in the port's Executor, on the CPU.

The cases of ``tests/unittests/test_recompute.py`` that apply to the
port, at small sizes (an MLP of six fc layers of width 32, a 1+1-layer
Transformer at d_model 32):

- against the JAX package with the same segment count, from the JAX
  startup's parameters: four Adam steps' losses, the first step's
  gradients and the last step's parameters within RTOL (the packages
  sum in different orders);
- against the port without recompute: bitwise, dropout 0.1 included,
  op by op and through a bound (captured) step — the recompute pass
  draws the forward's random bits;
- a ``while`` in the prefix: the variable it carries (written, never
  read through a declared input) lives across the pruned boundaries;
- ``enable_recompute`` after a bind makes the entry bind again;
- the environment is pruned: fewer bytes saved for backward (counted
  with ``torch.autograd.graph.saved_tensors_hooks``: a checkpointed
  segment's saves go to its own hooks) and fewer names alive after the
  prefix.

The mesh case (``test_recompute_under_parallel_executor_mesh``) waits
for the port's meshes (ROADMAP A11).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import executor as texe
from paddle_tpu_torch.models import transformer as TT

CPU = tfluid.CPUPlace()
RTOL = 1e-5     # port vs JAX: float32 sums in another order
ATOL = 1e-7
TINY = dict(batch_size=2, seq_len=16, src_vocab_size=60, trg_vocab_size=60,
            max_length=16, n_layer=1, n_head=2, d_model=32, d_inner=64,
            use_flash=True)


def _mlp(fl, segments, dropout=0.0, seed=3):
    """The reference test's model: six fc layers of width 32 (each
    followed by dropout where given), a softmax head, Adam."""
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = seed
    main.random_seed = seed + 1
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[16], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        h = x
        for _ in range(6):
            h = fl.layers.fc(input=h, size=32, act="relu")
            if dropout:
                h = fl.layers.dropout(h, dropout_prob=dropout)
        p = fl.layers.fc(input=h, size=4, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=p, label=y))
        fl.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    if segments:
        main.enable_recompute(segments)
    return main, startup, loss


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(8, 16).astype("float32"),
            "y": rng.randint(0, 4, size=(8, 1)).astype("int64")}


def _state(main, scope):
    return {n: np.array(scope[n]) for n in sorted(main.persistable_names())
            if n in scope}


def _port_steps(main, startup, fetch, feeds, use_program_cache=True,
                state=None):
    """A fresh scope and executor, startup (or ``state`` loaded), then a
    step a feed; returns (fetches a step as numpy, state, executor)."""
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    if state is None:
        exe.run(startup, scope=scope)
    else:
        tfluid.load_numpy_state(main, state, scope=scope, device="cpu")
    outs = [[np.array(v) for v in exe.run(
        main, feed=f, fetch_list=fetch, scope=scope,
        use_program_cache=use_program_cache)] for f in feeds]
    return outs, _state(main, scope), exe


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert a[n].tobytes() == b[n].tobytes(), n


@pytest.mark.parametrize("segments", [2, 4])
def test_recompute_matches_jax(segments):
    """The same Program built by each package, both with
    ``enable_recompute(segments)``, from the JAX startup's parameters:
    four steps' losses, the first step's gradients of two weights and
    the last parameters within RTOL."""
    feeds = [_feed(i) for i in range(4)]
    grads = ["fc_0.w_0@GRAD", "fc_5.w_0@GRAD"]
    jmain, jstart, jloss = _mlp(jfluid, segments)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        start = _state(jmain, jscope)
        want = [[np.asarray(v) for v in exe.run(
            jmain, feed=f, fetch_list=[jloss] + grads)] for f in feeds]
        want_state = _state(jmain, jscope)
    tmain, tstart, tloss = _mlp(tfluid, segments)
    got, got_state, _ = _port_steps(tmain, tstart, [tloss] + grads, feeds,
                                    state=start)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=RTOL, atol=0)
    for g, w in zip(got[0][1:], want[0][1:]):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())
    for n in ("fc_0.w_0", "fc_3.w_0", "fc_6.w_0"):
        np.testing.assert_allclose(got_state[n], want_state[n], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("use_program_cache", [False, True],
                         ids=["op_by_op", "bound"])
@pytest.mark.parametrize("segments", [2, 3, 4])
def test_recompute_is_bitwise_the_step_without(segments, use_program_cache):
    """With dropout 0.1 after every layer: four steps with recompute
    equal four without, bitwise (losses, every persistable), op by op
    and through a bound entry (its second run captures the step, with
    a recompute generator for each random op of a checkpointed
    segment)."""
    feeds = [_feed(i) for i in range(4)]
    runs = []
    for segs in (0, segments):
        main, startup, loss = _mlp(tfluid, segs, dropout=0.1)
        outs, state, exe = _port_steps(main, startup, [loss], feeds,
                                       use_program_cache)
        runs.append((outs, state))
        bound = [b for b in exe._bound.values() if b.step is not None]
        assert len(bound) == (1 if use_program_cache else 0)
        if segs and use_program_cache:
            keys = bound[0].rng_keys
            rec = [k for k in keys if k[2:] == ("recompute",)]
            assert rec and len(keys) == len(set(keys))
            assert {k[:2] for k in rec} < {k[:2] for k in keys
                                           if len(k) == 2}
    (lp, sp), (lr, sr) = runs
    assert [a[0].tobytes() for a in lp] == [b[0].tobytes() for b in lr]
    _assert_bitwise(sp, sr)


@pytest.mark.parametrize("use_program_cache", [False, True],
                         ids=["op_by_op", "bound"])
def test_transformer_recompute_is_bitwise_the_step_without(
        use_program_cache):
    """The Transformer at 1+1 layers, dropout 0.1, the flash op's plain
    version under its autograd Function: four Adam steps with
    ``enable_recompute(4)`` equal four without, bitwise."""
    feeds = _transformer_feeds(4)
    runs = []
    for segs in (0, 4):
        with tfluid.unique_name.guard():
            m = TT.get_model(dropout=0.1, **TINY)
        m["startup"].random_seed = 5
        m["main"].random_seed = 6
        if segs:
            m["main"].enable_recompute(segs)
        runs.append(_port_steps(m["main"], m["startup"], [m["loss"]], feeds,
                                use_program_cache)[:2])
    (lp, sp), (lr, sr) = runs
    assert [a[0].tobytes() for a in lp] == [b[0].tobytes() for b in lr]
    _assert_bitwise(sp, sr)


def _transformer_feeds(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {k: rng.randint(3, 60, size=(2, 16)).astype(np.int64)
             for k in ("src_word", "trg_word", "lbl_word")}
        f["src_word"][0, 12:] = 0
        f["trg_word"][1, 9:] = 0
        f["lbl_word"][1, 9:] = 0
        out.append(f)
    return out


def test_transformer_recompute_matches_jax():
    """The JAX package's 1+1-layer Transformer (dropout 0) handed over as
    its Program JSON, ``enable_recompute(4)`` on both sides: three
    steps' losses within RTOL."""
    with jfluid.unique_name.guard():
        jm = JT.get_model(dropout=0.0, **TINY)
    jm["main"].enable_recompute(4)
    feeds = _transformer_feeds(3)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jm["startup"])
        state = _state(jm["main"], jscope)
        want = [float(np.ravel(exe.run(jm["main"], feed=f,
                                       fetch_list=[jm["loss"]])[0])[0])
                for f in feeds]
    main = tfluid.Program.parse_from_string(jm["main"].to_string())
    main.enable_recompute(4)
    got, _, _ = _port_steps(main, None, [jm["loss"].name], feeds,
                            state=state)
    np.testing.assert_allclose([float(np.ravel(g[0])[0]) for g in got],
                               want, rtol=RTOL, atol=0)


def _while_program(fl):
    """The reference's liveness case: a counter made in the first
    segment and only written (an output of ``while``) in a later one."""
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 3
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[8], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        counter = fl.layers.zeros(shape=[1], dtype="int64")
        limit = fl.layers.fill_constant(shape=[1], dtype="int64", value=3)
        h = x
        for _ in range(4):
            h = fl.layers.fc(input=h, size=16, act="relu")
        cond = fl.layers.less_than(x=counter, y=limit)
        w = fl.layers.While(cond=cond)
        with w.block():
            fl.layers.increment(x=counter, value=1, in_place=True)
            fl.layers.less_than(x=counter, y=limit, cond=cond)
        p = fl.layers.fc(input=h, size=4, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=p, label=y))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.enable_recompute(3)
    return main, startup, loss, counter


def test_recompute_keeps_while_carried_vars_alive():
    """The ``while`` Program (never bound: ``while`` reads the host)
    recomputes op by op: the loss is finite, the counter the loop
    carried reads 3, and the loss and gradients match the JAX package's
    run of the same Program within RTOL."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 8).astype("float32"),
            "y": rng.randint(0, 4, (4, 1)).astype("int64")}
    jmain, jstart, jloss, jcounter = _while_program(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        start = _state(jmain, jscope)
        want = [np.asarray(v) for v in exe.run(
            jmain, feed=feed,
            fetch_list=[jloss, jcounter, "fc_0.w_0@GRAD"])]
    tmain, _, tloss, tcounter = _while_program(tfluid)
    (got,), _, exe = _port_steps(
        tmain, None, [tloss, tcounter, "fc_0.w_0@GRAD"], [feed],
        state=start)
    assert np.isfinite(got[0]).all()
    assert int(np.ravel(got[1])[0]) == 3 == int(np.ravel(want[1])[0])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL,
                               atol=RTOL * np.abs(want[2]).max())
    assert not exe._bound


def test_enable_recompute_after_a_bind_binds_again():
    """A bound, captured step; then ``enable_recompute(4)`` bumps the
    Program's version: the next run misses the entry, runs op by op and
    binds a new one, which captures at its second run.  The losses and
    the state stay bitwise those of a run that never recomputes."""
    feeds = [_feed(i) for i in range(6)]
    main, startup, loss = _mlp(tfluid, 0, dropout=0.1)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    c0 = texe.compile_count()
    losses = []
    for i, f in enumerate(feeds):
        if i == 3:
            (old,) = [b for b in exe._bound.values() if b.step is not None]
            v = main.version
            main.enable_recompute(4)
            assert main.version == v + 1
        losses.append(np.array(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0]))
    (new,) = exe._bound.values()
    assert new is not old and new.version == main.version
    assert new.step is not None and texe.compile_count() - c0 == 2
    assert any(k[2:] == ("recompute",) for k in new.rng_keys)
    plain, pstart, ploss = _mlp(tfluid, 0, dropout=0.1)
    want, want_state, _ = _port_steps(plain, pstart, [ploss], feeds)
    assert [a.tobytes() for a in losses] == [w[0].tobytes() for w in want]
    _assert_bitwise(_state(main, scope), want_state)


def _saved_bytes(main, startup, loss, feed):
    """Bytes of the tensors autograd saves for backward in one op-by-op
    step, as the outermost ``saved_tensors_hooks`` sees them."""
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                use_program_cache=False)
    return total[0]


def test_recompute_saves_fewer_bytes_for_backward():
    """The checkpointed segments keep none of their saved tensors: the
    bytes saved for backward fall, and fall further with more
    segments."""
    feed = {"x": np.random.RandomState(4).randn(64, 16).astype("float32"),
            "y": np.zeros((64, 1), "int64")}
    saved = {segs: _saved_bytes(*_mlp(tfluid, segs, dropout=0.1), feed)
             for segs in (0, 2, 4)}
    assert saved[4] < saved[2] < saved[0], saved


def test_recompute_prunes_the_environment():
    """After ``lower_block``, a recomputed step's environment holds the
    persistables, the feeds the post-ops read, the gradients and the
    kept names, not the prefix's activations."""
    main, startup, loss = _mlp(tfluid, 0)
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    feed = _feed()
    sizes = {}
    for segs in (0, 4):
        main._recompute_segments = segs
        env = {n: scope[n] for n in main.persistable_names() if n in scope}
        env.update({k: torch.as_tensor(v) for k, v in feed.items()})
        ctx = texe.LoweringContext(main, env, torch.device("cpu"), seed=1,
                                   keep_names=[loss.name])
        texe.lower_block(ctx, main.global_block())
        sizes[segs] = set(ctx.env)
    activations = {n for op in main.global_block().ops
                   if op.type in ("mul", "relu") for ns in op.outputs.values()
                   for n in ns}
    assert activations <= sizes[0]
    assert not activations & sizes[4]
    assert loss.name in sizes[4] and sizes[4] < sizes[0]


def test_segments_cut_the_prefix_by_op_count():
    ops = list(range(10))
    assert texe.recompute_segments(ops, 4) == [[0, 1], [2, 3, 4], [5, 6],
                                               [7, 8, 9]]
    assert texe.recompute_segments(ops[:3], 4) == [[0], [1], [2]]
