"""Service discovery + liveness registry (the etcd analog).

Reference: go/master/etcd_client.go:1-201 and
go/pserver/client/etcd_client.go — the reference coordinates its
distributed runtime through etcd: pservers REGISTER their endpoints under
leased keys, trainers DISCOVER pservers by reading those keys, liveness
is lease-TTL expiry, and state survives restarts via etcd's persistence.

The port's copy of the JAX package's ``transpiler/discovery.py``, on
the same wire (so a client of either package talks to a registry of
either).  There is no etcd; the same contract is rebuilt as a small
TCP registry service (length-prefixed pickle, pserver_runtime's
transport) with:

- ``register(key, value, ttl)`` -> lease id; the key disappears unless
  ``keepalive`` renews it within ttl (liveness = lease expiry, exactly
  the etcd model);
- ``lookup(prefix)`` -> {key: value} of live entries (trainer-side
  discovery of pserver endpoints);
- ``wait_for(prefix, n)`` -> block until n live entries exist (the
  reference's WaitIndex-style barrier for "all pservers up");
- disk snapshot + restore, so a restarted registry keeps its keyspace
  (etcd's persistence analog).

The registry is deliberately tiny: one process, host-side, never on the
device.  Multi-host deployments point ``PADDLE_REGISTRY`` at it; the
pserver runtime registers itself and trainers resolve endpoints through
it instead of static epmaps (transpiler/pserver_runtime.py).
"""
from __future__ import annotations

import os
import pickle
import socket
import threading
import time

from .pserver_runtime import _recv_msg as _recv, _send_msg as _send

__all__ = ["RegistryServer", "RegistryClient", "start_registry"]


class RegistryServer:
    """Leased key-value registry with disk persistence."""

    def __init__(self, host="127.0.0.1", port=0, snapshot_path=None,
                 sweep_interval=0.5):
        self._lock = threading.Lock()
        # key -> (value, expires_at or None, lease_id)
        self._kv: dict = {}
        self._next_lease = [1]
        self._snapshot_path = snapshot_path
        self._stop = threading.Event()
        if snapshot_path and os.path.exists(snapshot_path):
            with open(snapshot_path, "rb") as f:
                saved = pickle.load(f)
            now = time.monotonic()
            # restored leases get a fresh grace ttl: their owners must
            # re-keepalive or the sweep collects them (etcd lease restore)
            self._kv = {
                k: (v, (now + ttl) if ttl is not None else None, lease)
                for k, (v, ttl, lease) in saved.items()
            }
            self._next_lease[0] = 1 + max(
                [lease for (_, _, lease) in self._kv.values()], default=0)

        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(32)
        self.endpoint = "%s:%d" % self._srv.getsockname()
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True),
            threading.Thread(target=self._sweep_loop, args=(sweep_interval,), daemon=True),
        ]
        for t in self._threads:
            t.start()

    # -- internals -----------------------------------------------------------
    def _snapshot(self):
        if not self._snapshot_path:
            return
        now = time.monotonic()
        with self._lock:
            data = {
                k: (v, None if exp is None else max(0.0, exp - now), lease)
                for k, (v, exp, lease) in self._kv.items()
            }
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(data, f, protocol=4)
        os.replace(tmp, self._snapshot_path)

    def _sweep_loop(self, interval):
        while not self._stop.wait(interval):
            now = time.monotonic()
            with self._lock:
                dead = [k for k, (_, exp, _) in self._kv.items()
                        if exp is not None and exp < now]
                for k in dead:
                    del self._kv[k]
            if dead:
                self._snapshot()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn):
        try:
            while True:
                msg = _recv(conn)
                if msg is None:
                    return
                cmd, payload = msg
                _send(conn, self._handle(cmd, payload))
        except OSError:
            pass
        finally:
            conn.close()

    def _handle(self, cmd, payload):
        now = time.monotonic()
        if cmd == "register":
            key, value, ttl = payload
            with self._lock:
                lease = self._next_lease[0]
                self._next_lease[0] += 1
                self._kv[key] = (value, None if ttl is None else now + ttl, lease)
            self._snapshot()
            return ("ok", lease)
        if cmd == "keepalive":
            key, lease, ttl = payload
            with self._lock:
                cur = self._kv.get(key)
                if cur is None or cur[2] != lease:
                    return ("expired", None)  # etcd: renewing a dead lease fails
                self._kv[key] = (cur[0], None if ttl is None else now + ttl, lease)
            return ("ok", lease)
        if cmd == "lookup":
            prefix = payload
            with self._lock:
                out = {k: v for k, (v, exp, _) in self._kv.items()
                       if k.startswith(prefix) and (exp is None or exp >= now)}
            return ("ok", out)
        if cmd == "delete":
            key = payload
            with self._lock:
                self._kv.pop(key, None)
            self._snapshot()
            return ("ok", None)
        if cmd == "stop":
            self._stop.set()
            return ("ok", None)
        return ("error", "unknown command %r" % (cmd,))

    def close(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass


def start_registry(host="127.0.0.1", port=0, snapshot_path=None):
    return RegistryServer(host, port, snapshot_path)


class RegistryClient:
    """Client with automatic keepalive threads for registered keys."""

    def __init__(self, endpoint=None, timeout=30.0):
        endpoint = endpoint or os.environ.get("PADDLE_REGISTRY")
        if not endpoint:
            raise ValueError("no registry endpoint (arg or PADDLE_REGISTRY)")
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock = socket.create_connection(self._addr, timeout=timeout)
        self._keepalives: dict = {}

    def _call(self, cmd, payload):
        with self._lock:
            try:
                _send(self._sock, (cmd, payload))
                reply = _recv(self._sock)
            except OSError:
                # one transparent reconnect (registry restart)
                self._sock = socket.create_connection(self._addr, timeout=self._timeout)
                _send(self._sock, (cmd, payload))
                reply = _recv(self._sock)
        if reply is None:
            raise IOError("registry closed connection")
        status, value = reply
        if status == "error":
            raise RuntimeError(value)
        return status, value

    def register(self, key, value, ttl=5.0, keepalive=True):
        """Register under a lease; a daemon thread renews every ttl/3 until
        ``unregister`` (the etcd lease+keepalive pattern)."""
        # re-registering a key this client already renews must retire the
        # old renew thread first, or the two threads fight over the lease
        # (each 'expired' renewal re-registering yet another lease) and the
        # key can never be cleanly removed
        old = self._keepalives.pop(key, None)
        if old is not None:
            old[0].set()
        status, lease = self._call("register", (key, value, ttl))
        if keepalive and ttl is not None:
            stop = threading.Event()

            def renew(lease=lease):
                while not stop.wait(ttl / 3.0):
                    try:
                        st, _ = self._call("keepalive", (key, lease, ttl))
                        # lease lost (e.g. long GC pause): re-register and
                        # ADOPT the new lease id — but never after stop:
                        # an in-flight 'expired' racing unregister() would
                        # resurrect the deleted key
                        if st == "expired" and not stop.is_set():
                            _, lease = self._call("register", (key, value, ttl))
                    except (OSError, IOError):
                        pass  # registry briefly down; retry next tick

            t = threading.Thread(target=renew, daemon=True)
            t.start()
            self._keepalives[key] = (stop, t)
        return lease

    def unregister(self, key):
        ka = self._keepalives.pop(key, None)
        if ka:
            ka[0].set()
        self._call("delete", key)

    def lookup(self, prefix=""):
        _, out = self._call("lookup", prefix)
        return out

    def wait_for(self, prefix, n, timeout=60.0, poll=0.1):
        """Block until >= n live entries under prefix (reference: trainers
        wait for the full pserver set before training)."""
        deadline = time.monotonic() + timeout
        while True:
            out = self.lookup(prefix)
            if len(out) >= n:
                return out
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "only %d/%d entries under %r" % (len(out), n, prefix))
            time.sleep(poll)

    def close(self):
        for stop, _ in self._keepalives.values():
            stop.set()
        self._keepalives.clear()
        try:
            self._sock.close()
        except OSError:
            pass
