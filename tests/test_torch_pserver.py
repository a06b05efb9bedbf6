"""The parameter server (``transpiler/{distribute_transpiler,pserver_runtime,
ps_dispatcher}.py``) of the port against the JAX package's, on the CPU.

Both packages build the same Programs (the same ``to_string()`` JSON).
The port's startup state, from a seed, goes into every scope of both
packages: a trainer's whole, a pserver's cut to its slices.  Every
endpoint is a port the OS hands out; every thread is joined with a
timeout, and the port's clients give up connecting after a few seconds.

Limits: between the packages, trained parameters and losses 1e-5
relative and 1e-6 absolute (float32 GEMMs in another order); a sync
round against one step on the concatenated batch the same (the JAX
package's own test's); within the port, bitwise where the same work is
done in the same order (two trainers' copies, a restarted pserver
against an uninterrupted one, a Transformer through pservers against
its untranspiled run).

R-13, R-14 and R-15 (ROADMAP §C) each have a test here that shows the
JAX package's behaviour and the port's.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.transpiler import pserver_runtime as jrt
from paddle_tpu_torch.transpiler import pserver_runtime as trt

PKGS = {"jax": jfluid, "port": tfluid}
RTOL, ATOL = 1e-5, 1e-6
JOIN_S = 10.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _short_connect(monkeypatch):
    monkeypatch.setattr(trt, "CONNECT_TIMEOUT", 5.0)


def _free_ep():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return "127.0.0.1:%d" % s.getsockname()[1]


def _wait_listening(ep, timeout=JOIN_S):
    host, port = ep.rsplit(":", 1)
    deadline = time.monotonic() + timeout
    while True:
        try:
            socket.create_connection((host, int(port)), timeout=1).close()
            return
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def _fit_a_line(fl, opt="sgd", noam=False, d=4):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = L.data(name="x", shape=[d], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        pred = L.fc(input=x, size=1, param_attr=fl.ParamAttr(name="w"),
                    bias_attr=fl.ParamAttr(name="b"))
        cost = L.mean(L.square_error_cost(input=pred, label=y))
        lr = L.noam_decay(16, 4) if noam else 0.1
        (fl.optimizer.SGD(learning_rate=lr) if opt == "sgd"
         else fl.optimizer.Adam(learning_rate=lr)).minimize(cost)
    return main, startup, cost


def _deepfm(fl):
    from importlib import import_module

    M = import_module(fl.__name__ + ".models.deepfm")
    with fl.unique_name.guard():
        m = M.get_model(sparse_feature_dim=100, num_fields=6, lr=1e-2)
    return m["main"], m["startup"], m["loss"]


def _transformer(fl):
    from importlib import import_module

    M = import_module(fl.__name__ + ".models.transformer")
    with fl.unique_name.guard():
        m = M.get_model(batch_size=2, seq_len=8, src_vocab_size=32,
                        trg_vocab_size=32, max_length=8, n_layer=1, n_head=2,
                        d_model=16, d_inner=32, dropout=0.0)
    return m["main"], m["startup"], m["loss"]


def _line_feeds(n, rows=16, d=4, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, 1).astype("float32")
    out = []
    for _ in range(n):
        x = rng.randn(rows, d).astype("float32")
        out.append({"x": x, "y": x @ w + 0.1})
    return out


def _deepfm_feeds(n, rows=16, seed=0):
    rng = np.random.RandomState(seed)
    return [{"feat_ids": rng.randint(0, 100, (rows, 6)).astype("int64"),
             "label": rng.randint(0, 2, (rows, 1)).astype("float32")}
            for _ in range(n)]


def _tf_feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{k: rng.randint(3, 32, (2, 8)).astype("int64")
             for k in ("src_word", "trg_word", "lbl_word")} for _ in range(n)]


def _state(build, seed=3):
    """The port's startup state of ``build``'s Programs from ``seed``."""
    main, startup, _ = build(tfluid)
    startup.random_seed = seed
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    return {n: np.array(scope[n]) for n in main.persistable_names()
            if n in scope and scope[n] is not None}


def _scope(fl, state):
    s = fl.Scope()
    for n, v in state.items():
        s[n] = v
    return s


def _pserver_state(pprog, state):
    """``state`` cut to one pserver: a slice var gets its rows of its
    source (a [1]-shaped one a whole copy)."""
    slices = getattr(pprog, "_slice_vars", {})
    out = {}
    for v in pprog.list_vars():
        if not v.persistable:
            continue
        if v.name in slices:
            src, _, r0, r1 = slices[v.name]
            out[v.name] = state[src] if r0 is None else state[src][r0:r1]
        elif v.name in state:
            out[v.name] = state[v.name]
    return out


def _config(fl, sliced):
    cfg = fl.DistributeTranspilerConfig()
    if sliced:
        cfg.slice_var_up = True
        cfg.min_block_size = 16
    return cfg


class _Server:
    """One pserver of package ``fl`` in a thread: its startup run, then
    ``state`` (or a checkpoint) loaded, then the serve loop."""

    def __init__(self, fl, pprog, pstart, ep, state=None):
        self.scope = fl.Scope()
        self.exe = fl.Executor(fl.CPUPlace())
        self.exe.run(pstart, scope=self.scope)
        for n, v in (state or {}).items():
            self.scope[n] = v
        self.error = []

        def run():
            try:
                self.exe.run(pprog, scope=self.scope)
            except BaseException as exc:  # noqa: BLE001 - reported by join
                self.error.append(exc)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        _wait_listening(ep)

    def join(self):
        self.thread.join(JOIN_S)
        assert not self.thread.is_alive(), "the pserver did not stop"
        assert not self.error, self.error

    def get(self, name):
        return np.array(self.scope[name])


def _transpile(fl, build, trainer_id, eps, trainers, sliced):
    main, startup, loss = build(fl)
    t = fl.DistributeTranspiler(config=_config(fl, sliced))
    t.transpile(trainer_id=trainer_id, program=main, startup_program=startup,
                pservers=",".join(eps), trainers=trainers)
    return t, main, startup, loss


def _start_servers(fl, build, eps, trainers, sliced, state, ckpt=None):
    t, _, startup, _ = _transpile(fl, build, 0, eps, trainers, sliced)
    servers = []
    for ep in eps:
        pprog = t.get_pserver_program(ep)
        if ckpt is not None:
            pprog.global_block().ops[-1].attrs["checkpoint_dir"] = ckpt
        servers.append(_Server(fl, pprog, t.get_startup_program(
            ep, pprog, startup), ep, _pserver_state(pprog, state)))
    return servers


class _Trainer:
    """One trainer of package ``fl``: its transpiled Program and scope."""

    def __init__(self, fl, build, trainer_id, eps, trainers, sliced, state):
        t, main, _, self.loss = _transpile(fl, build, trainer_id, eps,
                                           trainers, sliced)
        self.program = t.get_trainer_program()
        self.params = [p.name for p in main.global_block().all_parameters()]
        self.scope = _scope(fl, state)
        self.exe = fl.Executor(fl.CPUPlace())
        self.losses = []

    def step(self, feed):
        (lv,) = self.exe.run(self.program, feed=feed, fetch_list=[self.loss],
                             scope=self.scope)
        self.losses.append(np.array(lv))
        if isinstance(self.exe, tfluid.Executor):
            # the bound entries, and how many have captured their step
            bound = self.exe._bound.values()
            self.bound = (len(bound), sum(b.step is not None for b in bound))

    def param_values(self):
        return {n: np.array(self.scope[n]) for n in self.params}

    def done(self, shutdown):
        if shutdown:
            self.exe.close()
        else:
            for c in getattr(self.exe, "_ps_clients", {}).values():
                c.close()


def _rounds(trainers, feeds):
    """Each trainer its feeds, one thread a trainer."""
    errors = []

    def run(i):
        try:
            for f in feeds[i]:
                trainers[i].step(f)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(1, len(trainers))]
    for th in threads:
        th.start()
    run(0)
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive(), "a trainer hung"
    if errors:
        raise errors[0]


def _cluster(build, state, feeds, trainer_pkgs=("port",), server_pkg="port",
             n_eps=1, sliced=False):
    """A whole run: pservers of ``server_pkg``, a trainer of each of
    ``trainer_pkgs`` with its feeds; trainer 0 closes (the pservers shut
    down).  Returns (trainers, servers)."""
    eps = [_free_ep() for _ in range(n_eps)]
    servers = _start_servers(PKGS[server_pkg], build, eps, len(trainer_pkgs),
                             sliced, state)
    trainers = [_Trainer(PKGS[p], build, i, eps, len(trainer_pkgs), sliced,
                         state) for i, p in enumerate(trainer_pkgs)]
    try:
        _rounds(trainers, feeds)
    finally:
        for i, tr in enumerate(trainers):
            tr.done(shutdown=i == 0)
        for s in servers:
            s.join()
    return trainers, servers


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)


def _without_r13(d):
    for blk in d["blocks"]:
        for op in blk["ops"]:
            op["attrs"].pop("forward_values", None)
    return d


# ---------------------------------------------------------------------------
# the transpiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["fit_a_line", "deepfm_sliced",
                                   "transformer_sliced"])
def test_transpiler_output_is_the_references(model):
    """The same Program (the JAX package's, through ``to_string``) and the
    same endpoints: the trainer Program, each pserver Program (its
    listen_and_serv attrs, sub-block ops, vars with their shapes) and
    each pserver startup equal the JAX package's JSON, but for R-13's
    ``forward_values``; the param slices too."""
    build, sliced = {"fit_a_line": (_fit_a_line, False),
                     "deepfm_sliced": (_deepfm, True),
                     "transformer_sliced": (_transformer, True)}[model]
    jmain, jstart, _ = build(jfluid)
    tmain = tfluid.Program.parse_from_string(jmain.to_string())
    tstart = tfluid.Program.parse_from_string(jstart.to_string())
    eps = ["127.0.0.1:1", "127.0.0.1:2"]
    ts = {}
    for fl, main, start in ((jfluid, jmain, jstart), (tfluid, tmain, tstart)):
        t = fl.DistributeTranspiler(config=_config(fl, sliced))
        t.transpile(trainer_id=1, program=main, startup_program=start,
                    pservers=",".join(eps), trainers=2)
        ts[fl] = t
    jt, tt = ts[jfluid], ts[tfluid]
    assert jt.param_slices == tt.param_slices
    if sliced:
        assert any(len(s) == 2 for s in tt.param_slices.values())

    def same(a, b, what):
        assert (_without_r13(json.loads(a.to_string()))
                == _without_r13(json.loads(b.to_string()))), what

    same(jt.get_trainer_program(), tt.get_trainer_program(), "trainer")
    for ep in eps:
        jp, tp = jt.get_pserver_program(ep), tt.get_pserver_program(ep)
        same(jp, tp, "pserver " + ep)
        same(jt.get_startup_program(ep, jp), tt.get_startup_program(ep, tp),
             "pserver startup " + ep)
        ls = tp.global_block().ops[-1]
        assert ls.sub_block.ops and ls.attrs["param_names"]


def test_r13_the_reference_pserver_reads_a_learning_rate_nothing_provides():
    """R-13, shown without running anything (the JAX package's pserver
    would fail its apply and its trainer hang): in the JAX package's
    pserver Program of a Transformer with noam decay, every adam op reads
    a LearningRate that is not persistable there, that no op of its
    startup writes, and that is not among its feeds (``grad_names``).
    The port lists that value on ``send`` and ``listen_and_serv``."""
    eps = ["127.0.0.1:1", "127.0.0.1:2"]
    for fl in (jfluid, tfluid):
        t, _, startup, _ = _transpile(fl, _transformer, 0, eps, 1, True)
        send = next(op for op in t.get_trainer_program().global_block().ops
                    if op.type == "send")
        for ep in eps:
            pprog = t.get_pserver_program(ep)
            ls = pprog.global_block().ops[-1]
            written = {n for op in t.get_startup_program(ep, pprog)
                       .global_block().ops for n in op.all_output_names()}
            lrs = {op.inputs["LearningRate"][0] for op in ls.sub_block.ops}
            assert len(lrs) == 1
            (lr,) = lrs
            assert not pprog.global_block().var(lr).persistable
            assert lr not in written and lr not in ls.attrs["grad_names"]
            if fl is jfluid:
                assert "forward_values" not in ls.attrs
                assert "forward_values" not in send.attrs
            else:
                assert ls.attrs["forward_values"] == [lr]
                assert send.attrs["forward_values"] == [lr]


_HASH_CHILD = r"""
import importlib.util, json, sys
out = {}
for pkg in ("paddle_tpu", "paddle_tpu_torch"):
    spec = importlib.util.spec_from_file_location(
        pkg + "_ps_dispatcher", sys.argv[1] + "/" + pkg +
        "/transpiler/ps_dispatcher.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    class V:
        def __init__(self, name):
            self.name = name
    names = ["fc_0.w_0", "fc_0.b_0", "deepfm_v", "fc_1.w_0"]
    eps = ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
    out[pkg] = mod.HashName(eps).dispatch([V(n) for n in names])
print(json.dumps(out))
"""


def test_r14_hash_name_gives_one_map_in_every_process():
    """R-14: three processes with PYTHONHASHSEED 1, 2 and 3 place four
    parameters over three endpoints.  The port's HashName (crc32) gives
    one map; the JAX package's (Python's salted ``hash``) gives more than
    one, so its trainer and pserver processes can disagree on who owns a
    gradient."""
    maps = {"paddle_tpu": set(), "paddle_tpu_torch": set()}
    for seed in ("1", "2", "3"):
        proc = subprocess.run([sys.executable, "-c", _HASH_CHILD, REPO],
                              env=dict(os.environ, PYTHONHASHSEED=seed),
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        for pkg, m in json.loads(proc.stdout).items():
            maps[pkg].add(tuple(m))
    assert len(maps["paddle_tpu_torch"]) == 1
    assert len(maps["paddle_tpu"]) > 1


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------


def test_a_round_sums_in_trainer_id_order():
    """Three trainers arriving as 2, 0, 1 and as 1, 2, 0: the apply sees
    (0 + g0 + g1 + g2) / 3 summed in that order, bitwise, both times.
    For two trainers that is bitwise the JAX package's sum in arrival
    order."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(64).astype("float32") * 10.0 ** rng.randint(-4, 4, 64)
             for _ in range(3)]
    want = ((np.add(0, grads[0]) + grads[1]) + grads[2]) / 3
    for order in ((2, 0, 1), (1, 2, 0)):
        seen = []
        rnd = trt._SyncRound(3, snapshot_fn=lambda: ({}, b""))
        threads = []
        for tid in order:
            th = threading.Thread(target=rnd.submit, args=(
                {"g": grads[tid].copy()},
                lambda feeds, applied: seen.append(feeds["g"].copy()),
                tid, 0), daemon=True)
            th.start()
            threads.append(th)
            time.sleep(0.05)
        for th in threads:
            th.join(JOIN_S)
        assert len(seen) == 1 and seen[0].tobytes() == want.tobytes()
    a, b = grads[0], grads[1]
    ref = jrt._SyncRound(2)
    ref_seen = []
    th = threading.Thread(target=ref.submit, args=(
        {"g": b}, lambda g: ref_seen.append(g["g"]), 1, 0), daemon=True)
    th.start()
    time.sleep(0.05)
    ref.submit({"g": a}, lambda g: ref_seen.append(g["g"]), 0, 0)
    th.join(JOIN_S)
    port = trt._average([(0, 1, {"g": a.copy()}), (1, 0, {"g": b.copy()})],
                        2, ())
    assert port["g"].tobytes() == ref_seen[0].tobytes()


def test_a_round_whose_forward_values_differ_fails_for_every_trainer():
    """R-13: the pserver applies the lowest trainer id's copy of a
    forward value, and a round where the copies differ in a bit fails
    (R-15) for both trainers."""
    seen, errors = [], []
    rnd = trt._SyncRound(2, ["lr"], snapshot_fn=lambda: ({}, b""))

    def submit(tid, lr, rid):
        try:
            rnd.submit({"g": np.ones(3, "float32"),
                        "lr": np.array([lr], "float32")},
                       lambda feeds, applied: seen.append(feeds["lr"]), tid,
                       rid)
        except trt.PServerError as exc:
            errors.append(str(exc))

    th = threading.Thread(target=submit, args=(1, 0.5, 0), daemon=True)
    th.start()
    time.sleep(0.05)
    submit(0, 0.5, 0)
    th.join(JOIN_S)
    assert [float(v[0]) for v in seen] == [0.5] and not errors
    th = threading.Thread(target=submit, args=(1, 0.5, 1), daemon=True)
    th.start()
    time.sleep(0.05)
    submit(0, np.nextafter(np.float32(0.5), np.float32(1)), 1)
    th.join(JOIN_S)
    assert len(seen) == 1 and len(errors) == 2
    assert all("'lr' differ" in e for e in errors)


def test_r15_a_failing_apply_reaches_the_trainer_as_an_error():
    """R-15.  The JAX package's round marks itself applied before its
    apply runs and keeps its count when the apply raises, so the next
    round never reaches its fanin and the trainers wait forever (shown on
    its ``_SyncRound``, without waiting).  The port's trainer gets the
    pserver's message as ``PServerError`` within 10 s, and the next round
    runs: here the apply fails because the trainer's send lists no
    forward value (R-13) that the pserver's optimize block reads."""
    ref = jrt._SyncRound(1)

    def fail(grads):
        raise KeyError("read before it was written")

    with pytest.raises(KeyError):
        ref.submit({"g": np.ones(2, "float32")}, fail, 0, 0)
    assert ref.applied == {0: 0} and ref.count == 1   # stuck at 1 of 1

    build = lambda fl: _fit_a_line(fl, noam=True)  # noqa: E731
    state = _state(build)
    ep = _free_ep()
    (server,) = _start_servers(tfluid, build, [ep], 1, False, state)
    tr = _Trainer(tfluid, build, 0, [ep], 1, False, state)
    send = next(op for op in tr.program.global_block().ops
                if op.type == "send")
    lr = send.attrs["forward_values"]
    assert len(lr) == 1
    feed = _line_feeds(1)[0]
    try:
        send.attrs["forward_values"] = []
        tr.program._bump()
        t0 = time.monotonic()
        with pytest.raises(trt.PServerError, match=lr[0]):
            tr.step(feed)
        assert time.monotonic() - t0 < 10.0
        send.attrs["forward_values"] = lr
        tr.program._bump()
        tr.step(feed)   # the failed round left nothing behind
        assert np.isfinite(tr.losses[-1]).all()
    finally:
        tr.done(shutdown=True)
        server.join()


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_line_run():
    build = _fit_a_line
    state = _state(build)
    feeds = [_line_feeds(8)]
    trainers, servers = _cluster(build, state, feeds, ("jax",), "jax")
    return state, feeds, trainers[0], servers[0]


@pytest.mark.parametrize("trainer,server", [("port", "port"), ("port", "jax"),
                                            ("jax", "port")])
def test_fit_a_line_through_a_pserver_matches_jax(jax_line_run, trainer,
                                                  server):
    """Eight rounds of fit-a-line (SGD 0.1), one trainer and one pserver,
    each of either package: the losses and the trained parameters (the
    trainer's and the pserver's) as the JAX trainer with the JAX pserver
    has them."""
    state, feeds, jt, js = jax_line_run
    (tr,), (srv,) = _cluster(_fit_a_line, state, feeds, (trainer,), server)
    _close(np.ravel(tr.losses), np.ravel(jt.losses), "losses")
    assert tr.losses[-1] < 0.2 * tr.losses[0]
    for n, v in jt.param_values().items():
        _close(tr.param_values()[n], v, n)
        _close(srv.get(n), js.get(n), "pserver " + n)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_a_two_trainer_round_is_one_step_on_the_concatenated_batch(pkg):
    """The round contract (the JAX package's
    ``test_sync_round_equals_single_node_step``): two trainers, one
    pserver, one round equals ``Executor.run``'s step of the same package
    on both halves concatenated (1e-5, 1e-6), and the two trainers hold
    the same parameters bitwise."""
    fl = PKGS[pkg]
    state = _state(_fit_a_line)
    halves = [_line_feeds(1, seed=s)[0] for s in (1, 2)]
    main, _, cost = _fit_a_line(fl)
    scope = _scope(fl, state)
    fl.Executor(fl.CPUPlace()).run(
        main, feed={k: np.concatenate([h[k] for h in halves])
                    for k in ("x", "y")}, fetch_list=[cost], scope=scope)
    trainers, (srv,) = _cluster(_fit_a_line, state, [[h] for h in halves],
                                (pkg, pkg), pkg)
    a, b = (t.param_values() for t in trainers)
    for n in ("w", "b"):
        _close(srv.get(n), np.array(scope[n]), n)
        assert a[n].tobytes() == b[n].tobytes() == srv.get(n).tobytes()


def test_deepfm_two_trainers_two_sliced_pservers():
    """P3 on the CPU: DeepFM (6 fields, 100 ids, Adam 1e-2), two trainers
    x two pservers, ``slice_var_up`` (its tables cut in two), 4 rounds:
    the trainers' parameters are bitwise equal after every round, the
    losses finite, and after round 1 the pservers' parameters are within
    1e-5 relative of one ``Executor.run`` step on the concatenated batch
    (the sliced ones put back together)."""
    state = _state(_deepfm)
    feeds = [_deepfm_feeds(4, seed=s) for s in (5, 6)]
    eps = [_free_ep(), _free_ep()]
    servers = _start_servers(tfluid, _deepfm, eps, 2, True, state)
    trainers = [_Trainer(tfluid, _deepfm, i, eps, 2, True, state)
                for i in range(2)]
    t, main, _, loss = _transpile(tfluid, _deepfm, 0, eps, 2, True)
    assert any(len(s) == 2 for s in t.param_slices.values())
    scope = _scope(tfluid, state)
    tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={k: np.concatenate([f[0][k] for f in feeds])
                    for k in feeds[0][0]}, fetch_list=[loss], scope=scope)
    bitwise, first = [], {}
    try:
        for k in range(4):
            _rounds(trainers, [[f[k]] for f in feeds])
            a, b = (tr.param_values() for tr in trainers)
            bitwise.append(all(a[n].tobytes() == b[n].tobytes() for n in a))
            if k == 0:
                first = {n: np.concatenate([servers[eps.index(ep)].get(sn)
                                            for sn, ep, _, _ in sl])
                         for n, sl in t.param_slices.items()}
    finally:
        for i, tr in enumerate(trainers):
            tr.done(shutdown=i == 0)
        for s in servers:
            s.join()
    assert all(bitwise), bitwise
    assert all(np.isfinite(tr.losses).all() for tr in trainers)
    for n, v in first.items():
        want = np.array(scope[n])
        err = np.abs(v - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-5, (n, err)


def test_transformer_with_noam_decay_is_bitwise_its_untranspiled_run():
    """R-13 end to end: a 1-layer Transformer (noam decay, Adam) through
    one trainer and two pservers with its embeddings row-sliced, 3
    rounds: the losses and every parameter bitwise ``Executor.run`` of
    the untranspiled Program from the same state on the same batches (one
    trainer averages g / 1, Adam is elementwise, and the pservers apply
    the trainer's LR).  The trainer's compute step binds once."""
    state = _state(_transformer)
    kept = {n: v.copy() for n, v in state.items()}
    feeds = _tf_feeds(3)
    main, _, loss = _transformer(tfluid)
    scope = _scope(tfluid, state)
    exe = tfluid.Executor(tfluid.CPUPlace())
    want = [np.array(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
            for f in feeds]
    (tr,), _ = _cluster(_transformer, state, [feeds], n_eps=2, sliced=True)
    assert [v.tobytes() for v in tr.losses] == [v.tobytes() for v in want]
    for n, v in tr.param_values().items():
        assert v.tobytes() == np.array(scope[n]).tobytes(), n
    assert tr.bound == (1, 1)
    for n, v in state.items():   # nothing written into the caller's arrays
        assert v.tobytes() == kept[n].tobytes(), n


def test_a_restarted_pserver_resumes_bitwise(tmp_path):
    """P4 on the CPU: two trainers, one pserver with a ``checkpoint_dir``
    (Adam, so moments and beta powers come back too), 6 rounds; the
    pserver is shut down after round 3 and started again from its
    checkpoint, and the trainers reconnect.  Their parameters after the
    last round are bitwise those of an uninterrupted run: no round was
    applied twice."""
    build = lambda fl: _fit_a_line(fl, opt="adam")  # noqa: E731
    state = _state(build)
    feeds = [_line_feeds(6, seed=s) for s in (1, 2)]
    whole, _ = _cluster(build, state, feeds, ("port", "port"))
    ep = _free_ep()
    ckpt = str(tmp_path)
    servers = _start_servers(tfluid, build, [ep], 2, False, state, ckpt)
    trainers = [_Trainer(tfluid, build, i, [ep], 2, False, state)
                for i in range(2)]
    try:
        _rounds(trainers, [f[:3] for f in feeds])
        poke = trt.PSClient(ep)
        poke.shutdown_server()
        poke.close()
        servers[0].join()
        assert os.path.exists(os.path.join(ckpt, "pserver_params.npz"))
        t, _, startup, _ = _transpile(tfluid, build, 0, [ep], 2, False)
        pprog = t.get_pserver_program(ep)
        pprog.global_block().ops[-1].attrs["checkpoint_dir"] = ckpt
        servers[0] = _Server(tfluid, pprog,
                             t.get_startup_program(ep, pprog, startup), ep)
        _rounds(trainers, [f[3:] for f in feeds])
    finally:
        for i, tr in enumerate(trainers):
            tr.done(shutdown=i == 0)
        servers[0].join()
    for a, b in zip(trainers, whole):
        assert [v.tobytes() for v in a.losses] == [v.tobytes()
                                                   for v in b.losses]
        for n, v in a.param_values().items():
            assert v.tobytes() == b.param_values()[n].tobytes(), n


def test_executor_close_shuts_the_pserver_down():
    """The pserver half of ``Executor.close`` (the rest is F-21): after one
    round, closing the trainer's Executor ends the serve loop and drops
    its connections; the losses are those of the round."""
    state = _state(_fit_a_line)
    ep = _free_ep()
    (server,) = _start_servers(tfluid, _fit_a_line, [ep], 1, False, state)
    tr = _Trainer(tfluid, _fit_a_line, 0, [ep], 1, False, state)
    tr.step(_line_feeds(1)[0])
    assert list(tr.exe._ps_clients) == [ep]
    tr.exe.close()
    assert tr.exe._ps_clients == {}
    server.join()
    assert tr.exe.last_pserver_round["round"] == 0
