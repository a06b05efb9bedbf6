"""Live metrics/health export: a stdlib HTTP plane over the registry.

A copy of the JAX package's export plane for the port.  The metric
names keep the ``paddle_tpu_`` prefix, so a scrape of either package
parses the same way.

Everything the registry accumulates — counters, gauges, timers,
histograms — is only as useful as an operator's ability to see it while
the process serves.  This module is the export half: a tiny
``http.server`` endpoint (OFF by default; nothing in the runtime starts
it) serving

- ``GET /metrics`` — Prometheus text exposition (format 0.0.4) of every
  cell.  Counters render as ``_total``, gauges as gauges, timers as
  summaries (``_seconds_count`` / ``_seconds_sum``), histograms as full
  ``_bucket{le="..."}`` ladders with ``_sum``/``_count`` — point a
  Prometheus scrape job at it and the serving SLO dashboards (p99 by
  class, shed rates, breaker state, desired replicas) come up with no
  agent in between.
- ``GET /healthz`` — the engine's ``health()`` dict as JSON (or a
  minimal registry summary when no health callable is wired).  Returns
  503 when the dict says ``ready: False``, so the SAME endpoint works as
  a load-balancer readiness probe.

:func:`render_prometheus` is the pure renderer — testable (and usable
for file-based node-exporter-style collection) without opening a
socket.  The server itself is a ``ThreadingHTTPServer`` on a daemon
thread: scrapes never block the serving workers, and a slow scraper
can't wedge the engine.
"""
from __future__ import annotations

import json
import re
import threading

from .registry import get_telemetry, split_labels

__all__ = ["render_prometheus", "MetricsServer", "prometheus_name",
           "parse_prometheus"]

_EXPO_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# one Prometheus text-exposition sample line: name{labels} value [timestamp]
# (the optional trailing millisecond timestamp appears on /federate output
# and many exporters — the scrape-driven autoscaler must parse those too)
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?) '
    r'(NaN|[+-]?Inf|[+-]?[0-9][0-9eE.+-]*)'
    r'( [+-]?[0-9]+)?$')
_TYPE_RE = re.compile(
    r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
    r"(counter|gauge|summary|histogram|untyped)$")


def parse_prometheus(text, strict=True):
    """Minimal exposition parser (the inverse of
    :func:`render_prometheus`): returns ``{sample_name: value}`` where
    ``sample_name`` includes any ``{labels}`` suffix verbatim; an
    optional trailing sample timestamp (``/federate`` output) is
    accepted and dropped.

    ``strict=True`` (the gate mode, for expositions WE rendered) raises
    ``ValueError`` on a malformed line, a duplicate sample, or two TYPE
    declarations for one family — the regressions a compliant Prometheus
    scraper would reject the whole exposition over.  ``strict=False``
    (the scrape mode — the autoscaler pointed at a third-party exporter
    or federation proxy) extracts every line this simple grammar CAN
    read and skips the rest (escaped-quote label values, exotic
    comments, tab separators), because one unreadable foreign line must
    not blind the consumer to the sample it came for; on a duplicate,
    the first wins."""
    samples = {}
    typed = set()
    for ln, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if not (m or line.startswith("# HELP")):
                if strict:
                    raise ValueError(
                        "malformed comment line %d: %r" % (ln, line))
                continue
            if m:
                fam = line.split()[2]
                # two TYPE declarations for one family (e.g. a timer AND
                # a histogram sharing a registry name) make a compliant
                # scraper reject the whole exposition
                if fam in typed:
                    if strict:
                        raise ValueError(
                            "duplicate metric family %r (line %d)"
                            % (fam, ln))
                    continue
                typed.add(fam)
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            if strict:
                raise ValueError(
                    "malformed sample line %d: %r" % (ln, line))
            continue
        name_part, value = m.group(1), m.group(2)
        v = float(value.replace("Inf", "inf"))
        if name_part in samples:
            if strict:
                raise ValueError(
                    "duplicate sample %r (line %d)" % (name_part, ln))
            continue
        samples[name_part] = v
    return samples


def prometheus_name(name, prefix="paddle_tpu_"):
    """Registry cell name -> Prometheus metric name: dots and every
    other non-``[a-zA-Z0-9_]`` character become underscores, with the
    namespace prefix prepended (``serving.queue_depth`` ->
    ``paddle_tpu_serving_queue_depth``)."""
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return prefix + safe


def _fmt(v):
    if v != v:                       # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _families(cells, prefix, suffix=""):
    """Group registry cells into Prometheus families: labeled cells
    (registry key ``name{k="v",...}``) collapse onto their base name's
    family, so one ``# TYPE`` line covers the unlabeled aggregate AND
    every label combination — a compliant scraper rejects duplicate TYPE
    declarations, which is exactly what per-cell TYPE lines would emit
    once tenant/model labels exist."""
    fams = {}
    for key, cell in cells.items():
        base, labels = split_labels(key)
        fams.setdefault(prometheus_name(base, prefix) + suffix, []).append(
            (labels, cell))
    return fams


def _merge_le(labels, le):
    """Bucket sample labels: the cell's own labels plus ``le``."""
    if not labels:
        return '{le="%s"}' % le
    return '%s,le="%s"}' % (labels[:-1], le)


def render_prometheus(telemetry=None, prefix="paddle_tpu_"):
    """Render every registry cell as Prometheus text exposition.

    Gauges holding non-numeric values (None before first write, string
    states) are skipped — the exposition format is numbers only; string
    state machines already publish numeric code gauges
    (``serving.breaker_state``).  Labeled cells (``name{k="v"}``
    registry keys, e.g. the tenant/model-tagged serving counters)
    render as label-suffixed samples under ONE family TYPE line,
    alongside the unlabeled aggregate sample when both exist."""
    tel = telemetry if telemetry is not None else get_telemetry()
    lines = []
    for m, group in sorted(_families(tel.counters(), prefix,
                                     "_total").items()):
        lines.append("# TYPE %s counter" % m)
        for labels, c in sorted(group):
            lines.append("%s%s %s" % (m, labels, _fmt(c.value)))
    for m, group in sorted(_families(tel.gauges(), prefix).items()):
        out = []
        for labels, g in sorted(group):
            v = g.value
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            out.append("%s%s %s" % (m, labels, _fmt(v)))
        if out:
            lines.append("# TYPE %s gauge" % m)
            lines.extend(out)
    hists = tel.histograms()
    hist_fams = _families(hists, prefix, "_seconds")
    timers = {key: t for key, t in tel.timers().items() if key not in hists}
    for m, group in sorted(_families(timers, prefix, "_seconds").items()):
        if m in hist_fams:
            # serving wires a Timer AND a Histogram onto the same name
            # (e.g. serving.queue_wait); both would render as
            # <name>_seconds with conflicting TYPE lines and duplicate
            # _sum/_count samples — a Prometheus parser rejects the
            # whole scrape.  The histogram subsumes the summary (same
            # _sum/_count plus the bucket ladder), so it wins — per
            # exact cell key AND per family name.
            continue
        lines.append("# TYPE %s summary" % m)
        for labels, t in sorted(group):
            stats = t.stats()
            count, total = (0, 0.0) if stats is None else (stats[0],
                                                           stats[1])
            lines.append("%s_count%s %s" % (m, labels, _fmt(count)))
            lines.append("%s_sum%s %s" % (m, labels, _fmt(total)))
    for m, group in sorted(hist_fams.items()):
        lines.append("# TYPE %s histogram" % m)
        for labels, h in sorted(group):
            snap = h.snapshot()
            for le, cum in snap.cumulative():
                lines.append('%s_bucket%s %s'
                             % (m, _merge_le(labels, _fmt(le)), _fmt(cum)))
            lines.append("%s_sum%s %s" % (m, labels, _fmt(snap.sum)))
            lines.append("%s_count%s %s" % (m, labels, _fmt(snap.count)))
    return "\n".join(lines) + "\n"


def _default_health():
    tel = get_telemetry()
    return {
        "ready": True,
        "telemetry_enabled": tel.enabled,
        "cells": {
            "counters": len(tel.counters()),
            "gauges": len(tel.gauges()),
            "timers": len(tel.timers()),
            "histograms": len(tel.histograms()),
        },
    }


class MetricsServer:
    """Start/stoppable HTTP exporter for ``/metrics`` and ``/healthz``.

    Parameters
    ----------
    host / port: bind address; ``port=0`` (the default) picks a free
        ephemeral port — read it back from :attr:`port` after
        :meth:`start`.
    health_fn: zero-arg callable returning a JSON-serializable dict
        (``InferenceEngine.health`` is the intended wiring); a dict with
        ``ready: False`` answers 503 so the endpoint doubles as a
        readiness probe.  Defaults to a minimal registry summary.
    telemetry: registry to export (default: the process-wide one).
    prefix: Prometheus namespace prefix for every metric name.

    Nothing in the runtime starts one of these implicitly — exporting
    is an operator decision (a port is an attack/operational surface),
    and a stopped server releases the port synchronously.
    """

    def __init__(self, host="127.0.0.1", port=0, health_fn=None,
                 telemetry=None, prefix="paddle_tpu_"):
        self.host = host
        self._requested_port = int(port)
        self._health_fn = health_fn or _default_health
        self._telemetry = telemetry
        self._prefix = prefix
        self._httpd = None
        self._thread = None
        self.scrapes = 0

    @property
    def running(self):
        return self._httpd is not None

    @property
    def port(self):
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._requested_port

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def start(self):
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):   # noqa: D401 — silence stderr
                pass

            def _reply(self, status, content_type, body):
                data = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        server.scrapes += 1
                        self._reply(200, _EXPO_CONTENT_TYPE,
                                    render_prometheus(server._telemetry,
                                                      server._prefix))
                    elif path in ("/healthz", "/health"):
                        health = server._health_fn()
                        status = (200 if health.get("ready", True) is not False
                                  else 503)
                        self._reply(status, "application/json",
                                    json.dumps(health, default=str))
                    else:
                        self._reply(404, "text/plain",
                                    "paddle_tpu metrics exporter: "
                                    "/metrics or /healthz\n")
                except BrokenPipeError:
                    pass            # scraper hung up mid-reply
                except Exception as exc:  # noqa: BLE001 — a broken
                    # health callable must answer 500, not kill the
                    # handler thread with a stack trace on stderr
                    try:
                        self._reply(500, "text/plain",
                                    "exporter error: %r\n" % (exc,))
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="paddle-tpu-metrics-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
