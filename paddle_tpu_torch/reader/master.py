"""Fault-tolerant data-dispatch master (reference analog: go/master —
service.go's chunk task queue with lease/timeout requeue).

One ``Master`` owns the epoch's chunk list (file paths, or any picklable
work units).  Trainers pull tasks over TCP; every lease carries a
deadline, and a chunk whose trainer dies (or just stalls past the lease)
is requeued and handed to the next caller — so a crashed trainer's data
is still trained on, at-least-once.  A chunk that fails ``max_failures``
times is dropped with a warning (reference: MaxChunksFailure).

The port's copy of the JAX package's ``reader/master.py``.  Transport is
the same length-prefixed pickle as the dense pserver
(transpiler/pserver_runtime.py), so a client of either package talks to
a master of either; the master is host-side control plane, never on
the device.

``snapshot_path`` persists the task state (todo/pending/failures) across
master restarts — the analog of the reference's master state in etcd
(go/master/etcd_client.go): a restarted master resumes the epoch with no
chunk lost; chunks that were leased at crash time are redispatched
(at-least-once, same as a lease expiry).
"""
from __future__ import annotations

import logging
import os
import pickle
import socket
import threading
import time

from ..transpiler.pserver_runtime import _recv_msg, _send_msg

__all__ = ["Master", "MasterClient", "master_task_reader"]

log = logging.getLogger(__name__)


class Master:
    """Chunk-queue server for one pass over the data."""

    def __init__(self, chunks, lease_seconds=10.0, max_failures=3,
                 snapshot_path=None):
        self._todo = [(i, c) for i, c in enumerate(chunks)]
        self._pending = {}  # task_id -> (chunk, deadline)
        self._failures = {}  # task_id -> count
        self._dropped = 0
        self._lock = threading.Lock()
        self._lease = float(lease_seconds)
        self._max_failures = int(max_failures)
        self._snapshot_path = snapshot_path
        self._persist_lock = threading.Lock()
        self._log_f = None
        if snapshot_path and os.path.exists(snapshot_path):
            self._restore(snapshot_path)
        elif snapshot_path:
            self._write_base()
        self._sock = None
        self._thread = None
        self._stop = threading.Event()
        self.port = None

    # -- persistence: base file + append-only event log ---------------------
    # The base file holds the epoch's full chunk list, written ONCE; each
    # ack/failure appends one tiny pickle record to ``<path>.log`` (O(1) per
    # event — a full-state rewrite per ack would be O(N) disk traffic per
    # event).  Leases are deliberately NOT persisted: a restart voids them
    # and redispatches every un-acked chunk, which is exactly the lease-
    # expiry semantics.  A completed pass unlinks both files so the next
    # epoch's Master starts from its chunks argument.

    def _write_base(self):
        with self._persist_lock:
            # truncate any stale log BEFORE the base lands: task ids are
            # dense indices, so a crash that paired a fresh base with a
            # previous epoch's log would replay colliding 'done' events and
            # silently drop never-served chunks
            open(self._snapshot_path + ".log", "wb").close()
            tmp = self._snapshot_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump({"todo": list(self._todo)}, f, protocol=4)
            os.replace(tmp, self._snapshot_path)

    def _restore(self, path):
        with open(path, "rb") as f:
            base = pickle.load(f)
        todo = dict(base["todo"])
        failures, dropped = {}, 0
        try:
            with open(path + ".log", "rb+") as f:
                good = 0
                while True:
                    try:
                        kind, tid = pickle.load(f)
                    except EOFError:
                        break
                    except Exception:
                        # torn final record (crash mid-append): drop it —
                        # and TRUNCATE, or post-recovery appends would land
                        # after the unreadable bytes and be lost to every
                        # later replay (re-running already-acked chunks)
                        f.truncate(good)
                        break
                    good = f.tell()
                    if kind == "done":
                        todo.pop(tid, None)
                    elif kind == "fail":
                        n = failures.get(tid, 0) + 1
                        failures[tid] = n
                        if n >= self._max_failures and tid in todo:
                            del todo[tid]
                            dropped += 1
        except FileNotFoundError:
            pass
        if not todo:
            # completed-pass leftover (crash between the last ack and the
            # unlink): a fresh epoch must NOT inherit an empty queue and
            # silently serve zero chunks
            log.warning("master: ignoring completed-pass snapshot %r", path)
            self._clear_snapshot()
            if self._todo:
                self._write_base()
            return
        self._todo = list(todo.items())
        self._failures = failures
        self._dropped = dropped

    def _log_event(self, kind, tid):
        if not self._snapshot_path:
            return
        with self._persist_lock:
            if self._log_f is None:
                self._log_f = open(self._snapshot_path + ".log", "ab")
            pickle.dump((kind, tid), self._log_f, protocol=4)
            self._log_f.flush()

    def _clear_snapshot(self):
        if not self._snapshot_path:
            return
        with self._persist_lock:
            if self._log_f is not None:
                self._log_f.close()
                self._log_f = None
            # log first, base second: a crash in between leaves a base with
            # no log (harmless full redispatch), never an orphan log that a
            # future epoch's base could be paired with
            for p in (self._snapshot_path + ".log", self._snapshot_path):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

    # -- queue core (usable in-process without the TCP layer) ---------------

    def _requeue_expired(self, now):
        expired = [tid for tid, (_, dl) in self._pending.items() if dl <= now]
        for tid in expired:
            chunk, _ = self._pending.pop(tid)
            self._fail_locked(tid, chunk, "lease expired")
        return expired

    def _fail_locked(self, tid, chunk, why):
        n = self._failures.get(tid, 0) + 1
        self._failures[tid] = n
        if n >= self._max_failures:
            self._dropped += 1
            log.warning("master: dropping chunk %r after %d failures (%s)", tid, n, why)
        else:
            self._todo.append((tid, chunk))

    def get_task(self):
        """-> ("task", id, chunk) | ("wait",) while leases are in flight |
        ("done",) when the pass is complete."""
        with self._lock:
            now = time.monotonic()
            expired = self._requeue_expired(now)
            if self._todo:
                tid, chunk = self._todo.pop(0)
                self._pending[tid] = (chunk, now + self._lease)
                out = ("task", tid, chunk)
            elif self._pending:
                out = ("wait",)
            else:
                out = ("done",)
        # expiries count as failures in the recovery log too (they feed the
        # max_failures drop rule); plain leases are not persisted — a
        # restart voids them by redispatching every un-acked chunk
        for tid_ in expired:
            self._log_event("fail", tid_)
        return out

    def task_finished(self, tid):
        with self._lock:
            changed = self._pending.pop(tid, None) is not None
            done = not self._todo and not self._pending
        if changed:
            self._log_event("done", tid)
        if done:
            self._clear_snapshot()

    def task_failed(self, tid):
        with self._lock:
            changed = tid in self._pending
            if changed:
                chunk, _ = self._pending.pop(tid)
                self._fail_locked(tid, chunk, "reported failed")
            done = not self._todo and not self._pending
        if changed:
            self._log_event("fail", tid)
        if done:
            self._clear_snapshot()

    def done(self):
        with self._lock:
            self._requeue_expired(time.monotonic())
            return not self._todo and not self._pending

    # -- TCP layer ----------------------------------------------------------

    def start(self, port=0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self.port

    def _serve(self):
        try:
            while not self._stop.is_set():
                try:
                    self._sock.settimeout(0.2)
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                threading.Thread(target=self._handle, args=(conn,), daemon=True).start()
        finally:
            try:
                self._sock.close()  # a client 'stop' must release the port too
            except OSError:
                pass

    def _handle(self, conn):
        try:
            while True:
                msg = _recv_msg(conn)
                if msg is None:
                    return
                op = msg[0]
                if op == "get":
                    _send_msg(conn, self.get_task())
                elif op == "finish":
                    self.task_finished(msg[1])
                    _send_msg(conn, ("ok",))
                elif op == "fail":
                    self.task_failed(msg[1])
                    _send_msg(conn, ("ok",))
                elif op == "stop":
                    _send_msg(conn, ("ok",))
                    self._stop.set()
                    return
                else:
                    _send_msg(conn, ("err", "unknown op %r" % (op,)))
        except OSError:
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2)


class MasterClient:
    def __init__(self, endpoint):
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=30)

    def _call(self, *msg):
        _send_msg(self._sock, msg)
        return _recv_msg(self._sock)

    def get_task(self, poll_interval=0.1):
        """Block until a task is available; None when the pass is done."""
        while True:
            resp = self._call("get")
            if resp is None:
                raise ConnectionError("master connection lost")
            if resp[0] == "task":
                return resp[1], resp[2]
            if resp[0] == "done":
                return None
            time.sleep(poll_interval)

    def task_finished(self, tid):
        self._call("finish", tid)

    def task_failed(self, tid):
        self._call("fail", tid)

    def stop_master(self):
        self._call("stop")

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def master_task_reader(endpoint, chunk_reader):
    """Reader factory: pull chunk tasks from the master at ``endpoint`` and
    stream ``chunk_reader(chunk)``'s records.  A chunk is acknowledged only
    after it is fully consumed, so a trainer that dies mid-chunk leaves the
    lease to expire and the chunk is redispatched to a surviving trainer
    (the fault-tolerant analog of ``cluster_files_reader``'s static
    sharding)."""

    def reader():
        client = MasterClient(endpoint)
        try:
            while True:
                task = client.get_task()
                if task is None:
                    return
                tid, chunk = task
                try:
                    for sample in chunk_reader(chunk):
                        yield sample
                except GeneratorExit:
                    raise
                except Exception:
                    client.task_failed(tid)
                    raise
                client.task_finished(tid)
        finally:
            client.close()

    return reader
