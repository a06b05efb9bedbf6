"""The port's service registry (``transpiler/discovery.py``, the etcd
analog) and data master (``reader/master.py``, the go/master analog),
and the pserver's restart from its checkpoint and registration in the
registry: the JAX package's own cases (``tests/unittests/test_discovery.py``,
``test_master_dispatch.py``) run against the port, and a client of each
package against a server of the other, since both speak the same wire
(length-prefixed pickle).  Endpoints are ports the OS hands out, and the
port's pserver clients give up connecting after a few seconds.
"""
import os
import pickle
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu.reader import master as jmaster
from paddle_tpu.transpiler import discovery as jdiscovery
from paddle_tpu_torch.reader.master import (Master, MasterClient,
                                            master_task_reader)
from paddle_tpu_torch.transpiler import pserver_runtime as trt
from paddle_tpu_torch.transpiler.discovery import (RegistryClient,
                                                   RegistryServer)


@pytest.fixture(autouse=True)
def _short_connect(monkeypatch):
    monkeypatch.setattr(trt, "CONNECT_TIMEOUT", 5.0)


# -- registry and pserver --------------------------------------------------


def test_registry_register_lookup_lease_expiry(tmp_path):
    srv = RegistryServer(snapshot_path=str(tmp_path / "reg.snap"))
    try:
        c = RegistryClient(srv.endpoint)
        # leased key WITHOUT keepalive dies after its ttl (liveness)
        c.register("pservers/a", "127.0.0.1:1", ttl=0.4, keepalive=False)
        # keepalive'd key stays alive past its ttl
        c.register("pservers/b", "127.0.0.1:2", ttl=0.4, keepalive=True)
        # permanent key (no lease)
        c.register("config/trainers", 2, ttl=None, keepalive=False)
        assert set(c.lookup("pservers/")) == {"pservers/a", "pservers/b"}
        time.sleep(1.2)
        live = c.lookup("pservers/")
        assert "pservers/a" not in live  # lease expired
        assert "pservers/b" in live      # renewed
        assert c.lookup("config/") == {"config/trainers": 2}
        c.unregister("pservers/b")
        assert c.lookup("pservers/") == {}
        c.close()
    finally:
        srv.close()


def test_registry_wait_for_barrier():
    srv = RegistryServer()
    try:
        c = RegistryClient(srv.endpoint)

        def late_register():
            time.sleep(0.3)
            c2 = RegistryClient(srv.endpoint)
            c2.register("ps/1", "e1", ttl=None, keepalive=False)

        threading.Thread(target=late_register, daemon=True).start()
        c.register("ps/0", "e0", ttl=None, keepalive=False)
        got = c.wait_for("ps/", 2, timeout=5.0)
        assert set(got.values()) == {"e0", "e1"}
        c.close()
    finally:
        srv.close()


def test_registry_snapshot_survives_restart(tmp_path):
    snap = str(tmp_path / "reg.snap")
    srv = RegistryServer(snapshot_path=snap)
    c = RegistryClient(srv.endpoint)
    c.register("config/x", {"dim": 4}, ttl=None, keepalive=False)
    c.close()
    srv.close()
    time.sleep(0.1)

    # fresh ephemeral port: the persistence contract is the SNAPSHOT, not
    # the port (rebinding the same port races TIME_WAIT on some kernels)
    srv2 = RegistryServer(snapshot_path=snap)
    try:
        c2 = RegistryClient(srv2.endpoint)
        assert c2.lookup("config/") == {"config/x": {"dim": 4}}
        c2.close()
    finally:
        srv2.close()


def _build_program():
    main = tfluid.Program()
    startup = tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=1, param_attr=tfluid.ParamAttr(name="w"),
                               bias_attr=tfluid.ParamAttr(name="b"))
        cost = tfluid.layers.mean(tfluid.layers.square_error_cost(input=pred, label=y))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost


def test_pserver_kill_and_resume_with_checkpoint(tmp_path):
    """The dense pserver restarts mid-training and resumes from its sync-
    round checkpoint; the trainer reconnects transparently and the final
    weights reach the optimum (reference analog: pserver recovery from
    etcd-coordinated checkpoints)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        ep = "127.0.0.1:%d" % s.getsockname()[1]

    main, startup, cost = _build_program()
    t = tfluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, startup_program=startup,
                pservers=ep, trainers=1)
    trainer_prog = t.get_trainer_program()
    pserver_prog = t.get_pserver_program(ep)
    pserver_startup = t.get_startup_program(ep, pserver_prog, startup)
    ls = pserver_prog.global_block().ops[-1]
    ls.attrs["checkpoint_dir"] = str(tmp_path)

    def serve_once(run_startup):
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())

        def run():
            with tfluid.scope_guard(scope):
                if run_startup:
                    exe.run(pserver_startup, scope=scope)
                else:
                    # crash-restart: params come from the checkpoint, but
                    # non-param state (lr schedules etc.) still needs init
                    exe.run(pserver_startup, scope=scope)
                exe.run(pserver_prog, scope=scope)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        return th

    rng = np.random.RandomState(0)
    X = rng.randn(64, 4).astype("float32")
    w_true = np.array([[1.0], [-2.0], [3.0], [0.5]], "float32")
    Y = X @ w_true + 0.1

    th1 = serve_once(run_startup=True)
    time.sleep(0.5)

    tr_scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = []
    with tfluid.scope_guard(tr_scope):
        exe.run(startup, scope=tr_scope)
        for _ in range(20):
            (lv,) = exe.run(trainer_prog, feed={"x": X, "y": Y},
                            fetch_list=[cost], scope=tr_scope)
            losses.append(float(np.ravel(lv)[0]))

        # "crash" the pserver: close its executor's serving loop abruptly
        # by sending shutdown (state save already happened per round), then
        # restart from the checkpoint dir on the same endpoint
        exe.close()
        th1.join(timeout=10)
        assert not th1.is_alive()
        assert os.path.exists(os.path.join(str(tmp_path), "pserver_params.npz"))

        th2 = serve_once(run_startup=False)
        time.sleep(0.5)
        for _ in range(40):
            (lv,) = exe.run(trainer_prog, feed={"x": X, "y": Y},
                            fetch_list=[cost], scope=tr_scope)
            losses.append(float(np.ravel(lv)[0]))
        w_final = np.array(tr_scope["w"])
        exe.close()
        th2.join(timeout=10)
        assert not th2.is_alive()

    # loss after resume continues from the checkpointed state: the first
    # post-restart loss must be well below the cold-start loss
    assert losses[20] < 0.5 * losses[0], (losses[0], losses[20])
    assert losses[-1] < 0.05 * losses[0]
    np.testing.assert_allclose(w_final, w_true, atol=0.3)


def test_pserver_registers_in_registry(tmp_path):
    """listen_and_serv with PADDLE_REGISTRY registers its endpoint under a
    liveness lease and removes it on shutdown."""
    import socket

    srv = RegistryServer()
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ep = "127.0.0.1:%d" % s.getsockname()[1]

        main, startup, cost = _build_program()
        t = tfluid.DistributeTranspiler()
        t.transpile(trainer_id=0, program=main, startup_program=startup,
                    pservers=ep, trainers=1)
        pserver_prog = t.get_pserver_program(ep)
        pserver_startup = t.get_startup_program(ep, pserver_prog, startup)
        pserver_prog.global_block().ops[-1].attrs["registry"] = srv.endpoint

        scope = tfluid.Scope()
        ps_exe = tfluid.Executor(tfluid.CPUPlace())

        def run():
            with tfluid.scope_guard(scope):
                ps_exe.run(pserver_startup, scope=scope)
                ps_exe.run(pserver_prog, scope=scope)

        th = threading.Thread(target=run, daemon=True)
        th.start()

        c = RegistryClient(srv.endpoint)
        got = c.wait_for("pservers/", 1, timeout=10.0)
        assert got == {"pservers/" + ep: ep}

        # trainer-side discovery instead of a static epmap
        exe = tfluid.Executor(tfluid.CPUPlace())
        trainer_prog = t.get_trainer_program()
        rng = np.random.RandomState(1)
        X = rng.randn(16, 4).astype("float32")
        Y = X @ np.ones((4, 1), "float32")
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            exe.run(trainer_prog, feed={"x": X, "y": Y}, fetch_list=[cost])
        exe.close()
        th.join(timeout=10)
        assert not th.is_alive()
        assert c.lookup("pservers/") == {}  # unregistered on shutdown
        c.close()
    finally:
        srv.close()


# -- master ----------------------------------------------------------------


def test_lease_timeout_requeues_chunk():
    m = Master(["c0", "c1", "c2"], lease_seconds=0.3)
    port = m.start()
    ep = "127.0.0.1:%d" % port

    # trainer A leases c0 and dies (never acks)
    a = MasterClient(ep)
    tid_a, chunk_a = a.get_task()
    a.close()

    # trainer B processes everything; after the lease expires it must also
    # receive A's chunk
    b = MasterClient(ep)
    seen = []
    while True:
        task = b.get_task(poll_interval=0.05)
        if task is None:
            break
        tid, chunk = task
        seen.append(chunk)
        b.task_finished(tid)
    b.close()
    m.stop()
    assert chunk_a in seen
    assert sorted(seen) == ["c0", "c1", "c2"]


def test_failed_task_redispatched_then_dropped():
    m = Master(["bad"], lease_seconds=30, max_failures=2)
    port = m.start()
    c = MasterClient("127.0.0.1:%d" % port)
    tid, _ = c.get_task()
    c.task_failed(tid)          # failure 1 -> requeued
    tid2, _ = c.get_task()
    assert tid2 == tid
    c.task_failed(tid2)         # failure 2 -> dropped
    assert c.get_task() is None
    c.close()
    m.stop()


def test_master_restart_mid_epoch_loses_no_chunks(tmp_path):
    """Kill-and-resume (reference: master state in etcd,
    go/master/etcd_client.go): a master restarted mid-epoch from its
    snapshot redispatches every unfinished chunk — including the one that
    was leased at crash time — and no chunk is lost or re-run after ack."""
    snap = str(tmp_path / "master.snap")
    chunks = ["c%d" % i for i in range(6)]

    m1 = Master(chunks, lease_seconds=30, snapshot_path=snap)
    port = m1.start()
    c = MasterClient("127.0.0.1:%d" % port)
    # finish two chunks, leave a third LEASED at crash time
    for _ in range(2):
        tid, _chunk = c.get_task()
        c.task_finished(tid)
    leased_tid, leased_chunk = c.get_task()
    c.close()
    m1.stop()  # crash: the lease is still outstanding

    # restart purely from the snapshot (chunks arg deliberately empty:
    # state must come from disk)
    m2 = Master([], lease_seconds=30, snapshot_path=snap)
    port2 = m2.start()
    c2 = MasterClient("127.0.0.1:%d" % port2)
    seen = []
    while True:
        task = c2.get_task(poll_interval=0.05)
        if task is None:
            break
        tid, chunk = task
        seen.append(chunk)
        c2.task_finished(tid)
    c2.close()
    m2.stop()

    # the crashed lease's chunk comes back FIRST (expired-lease semantics)
    assert seen[0] == leased_chunk
    # exactly the four unfinished chunks, each once
    assert sorted(seen) == sorted(set(chunks) - set(chunks[:2]))


def test_master_torn_log_record_truncated_on_recovery(tmp_path):
    """A crash mid-append tears the log's final record; recovery must
    truncate it so post-recovery acks survive the NEXT restart too."""
    snap = str(tmp_path / "m.snap")
    m1 = Master(["a", "b", "c", "d"], lease_seconds=30, snapshot_path=snap)
    port = m1.start()
    c = MasterClient("127.0.0.1:%d" % port)
    tid, _ = c.get_task()
    c.task_finished(tid)  # 'a' acked
    c.close()
    m1.stop()
    with open(snap + ".log", "ab") as f:
        f.write(b"\x80\x04torn")  # crash mid-append

    m2 = Master([], lease_seconds=30, snapshot_path=snap)
    port = m2.start()
    c = MasterClient("127.0.0.1:%d" % port)
    tid, chunk = c.get_task()
    assert chunk == "b"
    c.task_finished(tid)  # ack AFTER recovery: must persist durably
    c.close()
    m2.stop()

    m3 = Master([], lease_seconds=30, snapshot_path=snap)
    port = m3.start()
    c = MasterClient("127.0.0.1:%d" % port)
    seen = []
    while True:
        t = c.get_task(poll_interval=0.05)
        if t is None:
            break
        seen.append(t[1])
        c.task_finished(t[0])
    c.close()
    m3.stop()
    assert sorted(seen) == ["c", "d"]  # neither 'a' nor 'b' re-dispatched


def test_master_snapshot_cleared_after_pass_completes(tmp_path):
    """A completed pass unlinks its snapshot, so the next epoch's Master
    (same snapshot_path) serves its own chunk list — not a stale empty
    queue."""
    import os
    snap = str(tmp_path / "m.snap")

    def run_epoch(chunks):
        m = Master(chunks, lease_seconds=30, snapshot_path=snap)
        port = m.start()
        c = MasterClient("127.0.0.1:%d" % port)
        seen = []
        while True:
            t = c.get_task(poll_interval=0.05)
            if t is None:
                break
            seen.append(t[1])
            c.task_finished(t[0])
        c.close()
        m.stop()
        return seen

    assert sorted(run_epoch(["a", "b"])) == ["a", "b"]
    assert not os.path.exists(snap)  # completed pass cleaned up
    assert sorted(run_epoch(["c", "d", "e"])) == ["c", "d", "e"]


def test_master_task_reader_end_to_end(tmp_path):
    # three pickled sample files; two concurrent reader-trainers; one dies
    # mid-stream. Every sample is still consumed by the survivor.
    files = []
    for i in range(3):
        p = tmp_path / ("part-%d.pkl" % i)
        with open(p, "wb") as f:
            pickle.dump([(i, j) for j in range(4)], f)
        files.append(str(p))

    m = Master(files, lease_seconds=0.3)
    port = m.start()
    ep = "127.0.0.1:%d" % port

    def chunk_reader(path):
        with open(path, "rb") as f:
            yield from pickle.load(f)

    # trainer A: takes one task then abandons it (generator dropped mid-chunk)
    a = MasterClient(ep)
    abandoned_tid, abandoned_chunk = a.get_task()
    a.close()

    got = []
    r = master_task_reader(ep, chunk_reader)
    for sample in r():
        got.append(sample)
    m.stop()

    want = {(i, j) for i in range(3) for j in range(4)}
    assert set(got) == want


# -- across packages ---------------------------------------------------------


@pytest.mark.parametrize("server", ["port", "jax"])
def test_a_registry_client_of_the_other_package(server):
    """A registry of either package answers a client of the other: a key
    registered through one client is found through the other."""
    Server, Client = {
        "port": (RegistryServer, jdiscovery.RegistryClient),
        "jax": (jdiscovery.RegistryServer, RegistryClient)}[server]
    srv = Server()
    try:
        other = Client(srv.endpoint)
        other.register("pservers/a", "127.0.0.1:1", ttl=None, keepalive=False)
        same = (RegistryClient if server == "port"
                else jdiscovery.RegistryClient)(srv.endpoint)
        assert same.lookup("pservers/") == {"pservers/a": "127.0.0.1:1"}
        other.unregister("pservers/a")
        assert same.lookup("pservers/") == {}
        other.close()
        same.close()
    finally:
        srv.close()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_a_master_client_of_the_other_package(server):
    """A master of either package serves a client of the other the whole
    pass, a failed task again, and nothing twice."""
    M, C = {"port": (Master, jmaster.MasterClient),
            "jax": (jmaster.Master, MasterClient)}[server]
    m = M(["c0", "c1", "c2"], lease_seconds=30, max_failures=3)
    port = m.start()
    c = C("127.0.0.1:%d" % port)
    tid, chunk = c.get_task()
    c.task_failed(tid)
    seen = []
    while True:
        t = c.get_task(poll_interval=0.05)
        if t is None:
            break
        seen.append(t[1])
        c.task_finished(t[0])
    c.close()
    m.stop()
    assert sorted(seen) == ["c0", "c1", "c2"] and chunk in seen



# -- the wire ----------------------------------------------------------------


class _Writes:
    """A socket that records each ``sendall``."""

    def __init__(self):
        self.writes = []

    def sendall(self, data):
        self.writes.append(bytes(data))


@pytest.mark.parametrize("size", [0, 100, 1 << 16, (1 << 16) + 1])
def test_a_message_is_the_references_bytes_and_a_small_one_one_write(size):
    """Every message is a 4-byte length and pickle protocol 4, the JAX
    package's bytes.  Up to 64 KiB it goes in one write: the registry's
    and the master's sockets have Nagle on, and a body written after its
    length would wait for the peer's delayed ACK (on Linux loopback a
    registry lookup took about 90 ms in two writes, 0.03 ms in one)."""
    msg = ("lookup", "x" * size)
    sock = _Writes()
    trt._send_msg(sock, msg)
    body = pickle.dumps(msg, protocol=4)
    assert b"".join(sock.writes) == len(body).to_bytes(4, "little") + body
    assert len(sock.writes) == (1 if len(body) <= 1 << 16 else 2)
