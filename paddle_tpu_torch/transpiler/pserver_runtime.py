"""Host-side runtime for the distributed send/recv/listen_and_serv ops
(reference analog: operators/listen_and_serv_op.cc + distributed/grpc_*).

The port's counterpart of the JAX package's
``transpiler/pserver_runtime.py``.  Transport is the same, bit for bit:
a 4-byte little-endian length, then pickle protocol 4 of a tuple or a
dict of numpy arrays, over TCP.  Torch tensors never go on the wire, so
a trainer of either package works with a pserver of either package.

Sync semantics: with ``Fanin`` trainers, the server barriers each round:
grads from all trainers are summed in trainer-id order (for two trainers
bitwise the JAX package's sum in arrival order; for more, the same sum
every run) and *averaged* (sum / Fanin — each trainer sends mean-loss
grads for its shard, so averaging keeps the effective LR equal to a
single-node step on the combined batch), the optimize sub-block runs
once on the pserver's Executor (on the card unless the caller passed
``CPUPlace``; bound, so one CUDA graph a round from the second), and the
parameters go to the host once, into one snapshot that every trainer's
reply shares.

Two departures from the JAX package:
- R-13: the values listed as ``forward_values`` on ``listen_and_serv``
  (an LR schedule's output) come with the trainers' gradients and are
  fed to the apply; the lowest trainer id's copy is used, and a round
  whose copies differ in a bit fails.
- R-15: an apply that raises fails its round.  The round's state is
  reset, every waiting trainer gets an error reply, and ``push_pull``
  raises :class:`PServerError` with the pserver's message.  A round is
  recorded as applied only once its apply succeeded (the JAX package
  marks it first, so its trainers wait forever after a failed apply).

The trainer (:func:`run_trainer_step`) runs its compute as one bound
step (one CUDA graph on the card from the second round), fetches the
gradients through ``Executor.run``, sends every endpoint its shard
before it waits for any reply, and writes the fresh parameters with
``copy_`` into the scope's own tensors (row range by row range for a
sliced one), so that the captured step keeps reading them.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
import weakref

import numpy as np
import torch

from ..executor import _as_tensor, _host_tensor, as_numpy

__all__ = ["serve", "PSClient", "PServerError", "run_trainer_step"]

#: Seconds a PSClient keeps trying to connect: a pserver may still be
#: running its startup program.
CONNECT_TIMEOUT = 60.0
#: Seconds a connected socket waits in one send or receive.
IO_TIMEOUT = 60.0


def _send_bytes(sock, data):
    hdr = struct.pack("<I", len(data))
    if len(data) <= 1 << 16:
        # one write: a small body sent after its length would wait for
        # the peer's delayed ACK (Nagle) on a socket without TCP_NODELAY
        sock.sendall(hdr + data)
    else:
        # a large body is not copied to be joined to its length
        sock.sendall(hdr)
        sock.sendall(data)


def _send_msg(sock, obj):
    _send_bytes(sock, pickle.dumps(obj, protocol=4))


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            return None
        got += k
    return buf


def _recv_msg(sock):
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack("<I", hdr)
    buf = _recv_exact(sock, n)
    return None if buf is None else pickle.loads(buf)


def _no_delay(sock):
    # a message is two writes (length, then body): without this, Nagle's
    # rule holds the body's tail until the peer's delayed ACK
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class PServerError(RuntimeError):
    """A pserver failed the round (its apply raised); the message is the
    pserver's."""


class PSClient:
    """Trainer-side connection to one pserver endpoint."""

    def __init__(self, endpoint, connect_timeout=None):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        wait = CONNECT_TIMEOUT if connect_timeout is None else connect_timeout
        deadline = time.monotonic() + wait
        while True:
            try:
                self.sock = socket.create_connection((host, int(port)),
                                                     timeout=IO_TIMEOUT)
                break
            except OSError:
                # the pserver may still be running its startup program
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        _no_delay(self.sock)
        self.pickle_s = 0.0  # the last send's pickling time

    def send_grads(self, grads: dict, trainer_id=0, round_id=None):
        """The first half of :meth:`push_pull`: pickle and send."""
        t0 = time.perf_counter()
        data = pickle.dumps(("push_pull", (grads, trainer_id, round_id)),
                            protocol=4)
        self.pickle_s = time.perf_counter() - t0
        _send_bytes(self.sock, data)

    def recv_params(self) -> dict:
        """The second half of :meth:`push_pull`: the fresh params, or
        :class:`PServerError` for a failed round."""
        reply = _recv_msg(self.sock)
        if reply is None:
            raise IOError("pserver closed connection")
        if isinstance(reply, tuple) and len(reply) == 2 and reply[0] == "error":
            raise PServerError("pserver %s: %s" % (self.endpoint, reply[1]))
        return reply

    def push_pull(self, grads: dict, trainer_id=0, round_id=None) -> dict:
        """Send grads, barrier on the sync round, receive fresh params.

        ``(trainer_id, round_id)`` make the round EXACTLY-ONCE across
        reconnects: the server remembers each trainer's last applied round
        and treats a resend (retry after a torn connection) as a pull."""
        self.send_grads(grads, trainer_id, round_id)
        return self.recv_params()

    def pull(self, names) -> dict:
        _send_msg(self.sock, ("pull", list(names)))
        return _recv_msg(self.sock)

    def shutdown_server(self):
        try:
            _send_msg(self.sock, ("shutdown", None))
        except OSError:
            pass

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def _average(entries, fanin, forward_values):
    """The apply's feeds from one round's ``entries`` ((trainer_id,
    arrival, values), sorted): each gradient summed in that order and
    divided by ``fanin``; each forward value (R-13) the first entry's,
    after checking that every entry sent the same bits."""
    first = entries[0][2]
    out = {}
    for name in forward_values:
        if name not in first:
            raise KeyError("trainer %d sent no %r (R-13: the optimize block "
                           "reads it and the forward computes it)"
                           % (entries[0][0], name))
        want = np.asarray(first[name])
        for tid, _, vals in entries[1:]:
            got = np.asarray(vals.get(name))
            if (got.shape != want.shape or got.dtype != want.dtype
                    or got.tobytes() != want.tobytes()):
                raise ValueError(
                    "the trainers' copies of %r differ (trainer %d: %s, "
                    "trainer %d: %s); the pserver applies one value a round "
                    "(R-13)" % (name, entries[0][0], want.ravel()[:4], tid,
                                got.ravel()[:4]))
        out[name] = want
    for _, _, vals in entries:
        for name, v in vals.items():
            if name in forward_values:
                continue
            # the JAX package's sum, 0 + g0 + g1 + ..., in place in the
            # first entry's array (the round's own, unpickled): a fresh
            # array of a gradient's size costs its page faults each round
            acc = out.get(name)
            if acc is None:
                acc = np.asarray(v)
                out[name] = (np.add(0, acc, out=acc) if acc.flags.writeable
                             else np.add(0, acc))
            else:
                acc += np.asarray(v)
    if fanin != 1:   # x / 1 is x, bit for bit
        for name, v in out.items():
            if name not in forward_values:
                v /= fanin
    return out


class _SyncRound:
    """Barrier accumulator for one optimizer application.

    Exactly-once per (trainer, round): a retry after a torn connection
    must not double-count its gradients — duplicates just wait for (or
    observe) the round's completion.  ``snapshot_fn()`` gives (the
    params as numpy, their pickled reply): taken once a round, after
    its apply, and shared by every reply."""

    def __init__(self, fanin, forward_values=(), snapshot_fn=None):
        self.fanin = fanin
        self.forward_values = tuple(forward_values)
        self.snapshot_fn = snapshot_fn
        self.cond = threading.Condition()
        self.entries = []            # (trainer_id, arrival, values)
        self.generation = 0
        self.failure = None          # (generation, message) of a failed round
        self.contributed: dict = {}  # trainer_id -> last round_id counted
        self.applied: dict = {}      # trainer_id -> last round_id applied
        self.reply = None            # the last snapshot
        self.times = {}              # the last apply's seconds by part

    def _snapshot(self):
        if self.reply is None:
            self.reply = self.snapshot_fn()
        return self.reply

    def submit(self, values, apply_fn, trainer_id=0, round_id=None):
        """Add one trainer's values; the last arrival applies the
        optimizer.  Returns the snapshot after the round's apply;
        raises PServerError when the apply failed."""
        with self.cond:
            if round_id is not None and self.applied.get(trainer_id) == round_id:
                return self._snapshot()  # retry of a completed round: a pull
            gen = self.generation
            duplicate = (round_id is not None
                         and self.contributed.get(trainer_id) == round_id)
            if not duplicate:
                self.entries.append((trainer_id, len(self.entries), values))
                self.contributed[trainer_id] = round_id
            if len(self.entries) < self.fanin:
                while self.generation == gen:
                    self.cond.wait()
                if self.failure is not None and self.failure[0] == gen:
                    raise PServerError(self.failure[1])
                return self._snapshot()
            entries = sorted(self.entries, key=lambda e: e[:2])
            rounds = {tid: self.contributed.get(tid) for tid, _, _ in entries}
            self.entries = []
            self.generation += 1
            try:
                t0 = time.perf_counter()
                feeds = _average(entries, self.fanin, self.forward_values)
                t1 = time.perf_counter()
                # the checkpoint written after the apply must carry this
                # round as applied, or a retry after a crash right after
                # the save would apply it again
                apply_fn(feeds, {**self.applied, **rounds})
                t2 = time.perf_counter()
                self.reply = None
                snapshot = self._snapshot()
                self.times = {"average_s": t1 - t0, "apply_s": t2 - t1,
                              "snapshot_s": time.perf_counter() - t2}
            except Exception as exc:  # noqa: BLE001 - every waiter hears of it
                for tid in rounds:   # the round may be sent again
                    self.contributed.pop(tid, None)
                self.failure = (gen, "%s: %s" % (type(exc).__name__, exc))
                self.cond.notify_all()
                raise PServerError(self.failure[1]) from exc
            self.applied.update(rounds)
            self.cond.notify_all()
            return snapshot

    def abort(self, why):
        """Fail the round in progress (the server is stopping)."""
        with self.cond:
            if self.entries:
                for tid, _, _ in self.entries:
                    self.contributed.pop(tid, None)
                self.entries = []
                self.failure = (self.generation, why)
                self.generation += 1
                self.cond.notify_all()


def _restore(scope, name, value, device):
    """Write a checkpointed ``value`` with ``copy_`` into the scope's
    tensor of ``name`` (the one the pserver's startup made: its device,
    dtype and object stay); without one, the value is put there."""
    owner = scope._owner(name) or scope
    t = owner.vars.get(name)
    if isinstance(t, torch.Tensor) and tuple(t.shape) == np.shape(value):
        t.copy_(_host_tensor(value))
    else:
        owner.vars[name] = _as_tensor(value, None, device)


def _write_param(scope, name, parts):
    """Write a trainer's fresh parameter ``name`` from ``parts``, a list
    of (numpy value, (r0, r1) or None for the whole), with ``copy_`` into
    the scope's own tensor, so that the captured step that reads it stays
    bound.  A tensor this runtime (or a captured step) does not own yet
    (the startup's, or one sharing memory with a caller's array) is
    cloned once first and marked as a state buffer, so that nothing
    handed out before changes."""
    owner = scope._owner(name) or scope
    t = owner.vars[name]   # the compute step read it this round
    if not getattr(t, "_graph_state", False):
        t = t.clone()
        t._graph_state = True
        owner.vars[name] = t
    for value, rows in parts:
        (t if rows is None else t[rows[0]:rows[1]]).copy_(_host_tensor(value))


def serve(executor, program, scope):
    """Run a pserver program (a single listen_and_serv op).  Blocks until a
    trainer sends shutdown.  Reference: Executor runs listen_and_serv_op
    which blocks serving RPC.  After each round the seconds of its parts
    are in ``executor.last_pserver_apply``: ``average_s`` (the sum and
    the division), ``apply_s`` (the optimize block) and ``snapshot_s``
    (the params to the host and pickled).

    Fault tolerance (reference analog: go/pserver checkpointing + etcd
    registration, go/pserver/client/etcd_client.go): a ``checkpoint_dir``
    attr makes the server (a) RESTORE its persistables from the newest
    snapshot before serving, with ``copy_`` into the tensors its startup
    program made (device, dtype and tensor objects unchanged), and (b)
    atomically snapshot every ``checkpoint_interval`` rounds (8) and on
    shutdown.  With ``PADDLE_REGISTRY`` set (or a ``registry`` attr), the
    endpoint registers under ``pservers/<endpoint>`` with a liveness lease
    (transpiler/discovery.py) so trainers discover/re-resolve it."""
    from ..framework import Program

    ls = program.global_block().ops[-1]
    assert ls.type == "listen_and_serv"
    endpoint = ls.attrs["endpoint"]
    fanin = int(ls.attrs.get("Fanin", 1))
    grad_names = list(ls.attrs["grad_names"])
    param_names = list(ls.attrs["param_names"])
    forward_values = list(ls.attrs.get("forward_values", ()))
    opt_block = ls.sub_block
    ckpt_dir = ls.attrs.get("checkpoint_dir")
    # snapshotting every round would put full-checkpoint disk I/O on every
    # barrier (the reference checkpoints on an interval); default every 8
    # rounds, plus an unconditional save on graceful shutdown below
    ckpt_interval = int(ls.attrs.get("checkpoint_interval", 8) or 1)
    rounds_done = [0]

    def snapshot():
        params = {p: as_numpy(scope[p]) for p in param_names}
        return params, pickle.dumps(params, protocol=4)

    round_ = _SyncRound(fanin, forward_values, snapshot)

    # every persistable of the pserver program is checkpointed — restoring
    # params alone would silently reset Adam moments / momentum / LR
    # counters on restart
    ckpt_names = sorted({v.name for v in program.list_vars() if v.persistable})

    if ckpt_dir:
        path = os.path.join(ckpt_dir, "pserver_params.npz")
        if os.path.exists(path):
            loaded = np.load(path)
            for name in loaded.files:
                if name not in ("__applied_tid__", "__applied_round__"):
                    _restore(scope, name, loaded[name], executor.device)
            # restore the exactly-once dedup map so a retry of the round
            # whose apply the snapshot captured is NOT applied again
            if "__applied_tid__" in loaded.files:
                for tid, rid in zip(loaded["__applied_tid__"],
                                    loaded["__applied_round__"]):
                    round_.applied[int(tid)] = int(rid)
                    round_.contributed[int(tid)] = int(rid)

    def save_checkpoint(applied, force=False):
        if not ckpt_dir:
            return
        if not force and rounds_done[0] % ckpt_interval != 0:
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, "pserver_params.npz")
        tmp = path + ".tmp.npz"
        arrays = {p: as_numpy(scope[p]) for p in ckpt_names
                  if p in scope and scope[p] is not None}
        applied = {t: r for t, r in applied.items() if r is not None}
        if applied:
            arrays["__applied_tid__"] = np.array(sorted(applied), np.int64)
            arrays["__applied_round__"] = np.array(
                [applied[t] for t in sorted(applied)], np.int64)
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    registry_client = None
    registry_ep = ls.attrs.get("registry") or os.environ.get("PADDLE_REGISTRY")
    if registry_ep:
        from .discovery import RegistryClient

        try:
            registry_client = RegistryClient(registry_ep)
            registry_client.register("pservers/" + endpoint, endpoint, ttl=5.0)
        except (OSError, ValueError):
            registry_client = None  # registry down: serve anyway

    # one-block program that applies the optimizer ops given grad feeds
    apply_prog = Program()
    blk = apply_prog.global_block()
    for v in program.global_block().vars.values():
        blk.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                       persistable=v.persistable)
    for op in opt_block.ops:
        blk.append_op(type=op.type, inputs=dict(op.inputs),
                      outputs=dict(op.outputs), attrs=dict(op.attrs))

    def apply_fn(feeds, applied):
        executor.run(apply_prog, feed=feeds, fetch_list=[], scope=scope)
        rounds_done[0] += 1
        save_checkpoint(applied)

    stop = threading.Event()
    conns = []

    host, port = endpoint.rsplit(":", 1)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, int(port)))
    srv.listen(16)

    def handle(conn):
        if executor.device.type == "cuda":
            torch.cuda.set_device(executor.device)  # this thread's context
        try:
            while not stop.is_set():
                msg = _recv_msg(conn)
                if msg is None:
                    return
                cmd, payload = msg
                if cmd == "push_pull":
                    # payload: legacy {grads} or (grads, trainer_id, round_id)
                    if isinstance(payload, tuple):
                        raw, trainer_id, round_id = payload
                    else:
                        raw, trainer_id, round_id = payload, 0, None
                    values = {n: raw[n] for n in grad_names + forward_values
                              if n in raw}
                    try:
                        _, reply = round_.submit(values, apply_fn,
                                                 trainer_id, round_id)
                    except PServerError as exc:
                        _send_msg(conn, ("error", str(exc)))
                        continue
                    executor.last_pserver_apply = dict(round_.times)
                    _send_bytes(conn, reply)
                elif cmd == "pull":
                    with round_.cond:
                        params = {p: as_numpy(scope[p]) for p in payload
                                  if p in scope}
                    _send_msg(conn, params)
                elif cmd == "shutdown":
                    stop.set()
                    # unblock accept()
                    try:
                        poke = socket.create_connection((host, int(port)),
                                                        timeout=5)
                        poke.close()
                    except OSError:
                        pass
                    return
        except OSError:
            pass  # a torn connection: the trainer reconnects and resends
        finally:
            conn.close()

    threads = []
    while not stop.is_set():
        try:
            conn, _ = srv.accept()
        except OSError:
            break
        if stop.is_set():
            conn.close()
            break
        _no_delay(conn)
        conns.append(conn)
        t = threading.Thread(target=handle, args=(conn,), daemon=True,
                             name="pserver-%s" % endpoint)
        t.start()
        threads.append(t)
    srv.close()
    # every other trainer's connection ends here, and a round still
    # waiting for its trainers fails: no handler outlives the server
    round_.abort("pserver %s shut down" % endpoint)
    for conn in conns:
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    for t in threads:
        t.join(timeout=5)
    # graceful shutdown: persist the latest state
    save_checkpoint(dict(round_.applied), force=True)
    if registry_client is not None:
        try:
            registry_client.unregister("pservers/" + endpoint)
            registry_client.close()
        except (OSError, IOError):
            pass
    return []


class _TrainerPlan:
    """One transpiled trainer Program's compute clone (its ops without
    send and recv, made once a Program version, so that its bound entry
    and graph survive between rounds) and its round counter."""

    __slots__ = ("version", "compute", "round")


_PLANS = weakref.WeakKeyDictionary()


def _plan(program):
    plan = _PLANS.get(program)
    if plan is None or plan.version != program.version:
        compute = program.clone()
        cblk = compute.global_block()
        cblk.ops = [op for op in cblk.ops if op.type not in ("send", "recv")]
        compute._bump()
        fresh = _TrainerPlan()
        fresh.version, fresh.compute = program.version, compute
        fresh.round = 0 if plan is None else plan.round
        plan = _PLANS[program] = fresh
    return plan


def _exchange(clients, by_ep, trainer_id, round_id):
    """One round with every endpoint: each gets its values before any
    reply is awaited (the pservers apply at once), then each reply is
    read.  A torn connection is reconnected and the values sent again
    (the server dedups by (trainer, round)), up to three times.  Every
    reply is read before a failed round's PServerError is raised, so no
    connection is left holding an unread reply.  Returns (the fresh
    params, the seconds spent pickling)."""
    sent = {}
    pickle_s = 0.0
    for ep, values in by_ep.items():
        try:
            clients[ep].send_grads(values, trainer_id, round_id)
            pickle_s += clients[ep].pickle_s
            sent[ep] = True
        except OSError:
            sent[ep] = False
    fresh, failure = {}, None
    for ep, values in by_ep.items():
        for attempt in range(3):
            if not sent[ep]:
                # a pserver restart drops the TCP connection; PSClient
                # waits for the endpoint to come back
                clients[ep].close()
                clients[ep] = PSClient(ep)
            try:
                if not sent[ep]:
                    clients[ep].send_grads(values, trainer_id, round_id)
                    pickle_s += clients[ep].pickle_s
                    sent[ep] = True
                fresh.update(clients[ep].recv_params())
                break
            except PServerError as exc:
                failure = failure or exc
                break
            except OSError:
                if attempt == 2:
                    raise
                sent[ep] = False
    if failure is not None:
        raise failure
    return fresh, pickle_s


def run_trainer_step(executor, program, feed, fetch_list, scope, clients,
                     return_numpy=True):
    """Run a transpiled trainer program: its compute as one bound step
    through ``executor.run``, then the send/recv round.  The round's
    times go to ``executor.last_pserver_round`` (seconds): ``compute_s``
    (the step, waited for), ``fetch_s`` (the gradients and forward values
    to numpy, and their pickling), ``wire_s`` (the wire and the pservers'
    apply), ``copy_s`` (the fresh params into the scope's tensors)."""
    from ..framework import Variable

    blk = program.global_block()
    send_op = next(op for op in blk.ops if op.type == "send")
    recv_op = next(op for op in blk.ops if op.type == "recv")
    plan = _plan(program)

    grad_names = list(send_op.inputs["X"])
    forward_values = list(send_op.attrs.get("forward_values", ()))
    fetch_names = [f.name if isinstance(f, Variable) else str(f)
                   for f in (fetch_list or [])]
    t0 = time.perf_counter()
    res = executor.run(plan.compute, feed=feed,
                       fetch_list=fetch_names + grad_names + forward_values,
                       scope=scope, return_numpy=return_numpy)
    if executor.device.type == "cuda":
        torch.cuda.current_stream(executor.device).synchronize()
    t1 = time.perf_counter()
    n = len(fetch_names)
    grad_vals = {g: as_numpy(v) for g, v in zip(grad_names, res[n:])}
    extra = {name: as_numpy(v) for name, v in
             zip(forward_values, res[n + len(grad_names):])}

    # group grads per endpoint; with slice_var_up a grad is split row-wise
    # into the per-pserver slices the transpiler assigned.  The forward
    # values go to every endpoint
    epmap = dict(zip(grad_names, send_op.attrs["epmap"]))
    grad_slices = send_op.attrs.get("slices") or {}
    by_ep = {}
    for g, v in grad_vals.items():
        for sname, ep, r0, r1 in (grad_slices.get(g)
                                  or [(g, epmap[g], None, None)]):
            by_ep.setdefault(ep, dict(extra))[sname] = (
                v if sname == g else v[r0:r1])
    # per-program monotonically increasing round id: with the trainer_id
    # below it makes each sync round exactly-once server-side, so a retry
    # after a torn connection can never double-apply gradients
    round_id = plan.round
    plan.round += 1
    trainer_id = int(send_op.attrs.get("trainer_id", 0))
    t2 = time.perf_counter()
    fresh, pickle_s = _exchange(clients, by_ep, trainer_id, round_id)
    t3 = time.perf_counter()

    # the fresh params into the scope's own tensors, a sliced one row
    # range by row range
    param_slices = recv_op.attrs.get("slices") or {}
    for pname in recv_op.outputs["Out"]:
        slices = param_slices.get(pname) or [(pname, None, None, None)]
        if len(slices) == 1 and slices[0][0] == pname:
            if pname in fresh:
                _write_param(scope, pname, [(fresh[pname], None)])
        else:
            _write_param(scope, pname, [(fresh[sname], (r0, r1))
                                        for sname, _, r0, r1 in slices])
    t4 = time.perf_counter()
    executor.last_pserver_round = {
        "round": round_id, "compute_s": t1 - t0,
        "fetch_s": t2 - t1 + pickle_s, "wire_s": t3 - t2 - pickle_s,
        "copy_s": t4 - t3}
    return res[:n]
