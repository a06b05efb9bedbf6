#!/usr/bin/env python
"""Gate for the port's observability plane (``paddle_tpu_torch.
observability``): run a real ``Trainer`` loop on the CPU with the sinks
attached and fail loudly on any schema or neutrality regression.  The
port's counterpart of ``tools/check_observability.py``, scenarios 1-3.

Scenario 1 — JSONL step-record schema:
  train with checkpoints + nan_guard and the JSONL sink attached.  Every
  line must parse; every trainer step record must carry the required
  STEP_SCHEMA fields (steps/s, feed host-copy count, prefetch transfer
  count, NaN-guard verdict); checkpoint steps must carry save durations;
  the executor's records show its fast path engaged.

Scenario 2 — Chrome-trace export:
  the trace file must be valid trace_event JSON (loads in Perfetto),
  contain per-thread metadata, dispatch spans on the main thread AND
  conversion/transfer spans on the prefetch thread, with at least one
  prefetch activity before the last dispatch ends.  Whether a prefetch
  span overlaps a dispatch span in wall time is reported, not asserted:
  on a shared CPU box it is scheduler luck (the JAX package's gate
  asserts it on two cores or more).

Scenario 3 — bitwise neutrality:
  the same training run with telemetry sinks attached vs detached must
  produce bitwise-identical parameters and losses, and the contract
  counters (feed_host_copy_count / transfer_count) must match exactly.

The JAX package's scenario 4, a per-call time budget of the disabled
path, depends on the host's load and is not part of this CPU gate.

Runnable locally (the port only: no jax is imported):
    python tools/check_observability_torch.py
and run under pytest by tests/test_torch_observability_gate.py.

Exit code 0 = every scenario held.
"""
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def _train_func():
    import paddle_tpu_torch as fluid

    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1, param_attr=fluid.ParamAttr(name="w"))
    return fluid.layers.mean(fluid.layers.square_error_cost(input=pred, label=y))


def _optimizer_func():
    import paddle_tpu_torch as fluid

    return fluid.optimizer.SGD(learning_rate=0.05)


def _reader():
    rng = np.random.RandomState(0)
    w = np.array([[1.0], [2.0], [-1.0], [0.5]], "float32")
    for _ in range(8):
        x = rng.randn(16, 4).astype("float32")
        yield list(zip(x, x @ w))


def _train(cdir=None, sinks=(), losses=None):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observability as obs

    cfg = None
    if cdir is not None:
        cfg = fluid.CheckpointConfig(checkpoint_dir=cdir,
                                     max_num_checkpoints=5, step_interval=3)
    np.random.seed(7)  # pins startup init across runs
    for s in sinks:
        obs.add_sink(s)
    try:
        t = fluid.Trainer(_train_func, _optimizer_func,
                          place=fluid.CPUPlace(), checkpoint_config=cfg,
                          resume=False)

        def grab(e):
            if losses is not None and isinstance(e, fluid.EndStepEvent):
                losses.append(np.asarray(e.metrics[0]).tobytes())

        t.train(num_epochs=1, event_handler=grab, reader=_reader,
                feed_order=["x", "y"], nan_guard=True)
        return np.asarray(t.scope.vars["w"]).copy()
    finally:
        for s in sinks:
            obs.remove_sink(s)


def scenario_jsonl_schema():
    from paddle_tpu_torch import observability as obs

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "telemetry.jsonl")
        sink = obs.JsonlSink(path)
        _train(cdir=os.path.join(td, "ckpt"), sinks=[sink])
        sink.close()
        records = [json.loads(line) for line in open(path)]  # must all parse
        steps = [r for r in records if r.get("type") == "step"
                 and r.get("source") == "trainer"
                 and r.get("phase") == "train"]
        assert steps, "no trainer step records in the JSONL sink"
        for r in steps:
            missing = [k for k in obs.STEP_SCHEMA["required"] if k not in r]
            assert not missing, "step record missing %s: %s" % (missing, r)
        assert all(r["nan_ok"] is True for r in steps), (
            "guarded clean run must report nan_ok=True verdicts")
        assert all(isinstance(r["steps_per_s"], float) and r["steps_per_s"] > 0
                   for r in steps)
        assert steps[-1]["feed_host_copies"] >= 0
        assert steps[-1]["prefetch_transfers"] >= len(steps) - 1, (
            "prefetch transfers not reported: %s"
            % steps[-1]["prefetch_transfers"])
        saves = [r["checkpoint_save_s"] for r in steps
                 if r.get("checkpoint_save_s") is not None]
        assert saves and all(s > 0 for s in saves), (
            "no checkpoint save durations in step records")
        exe_steps = [r for r in records if r.get("source") == "executor"]
        assert exe_steps and any(r.get("fast_path") for r in exe_steps), (
            "executor records missing, or fast path never engaged")
    return "jsonl schema: %d step records, all required fields OK" % len(steps)


def scenario_chrome_trace():
    from paddle_tpu_torch import observability as obs

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        sink = obs.ChromeTraceSink(path)
        _train(cdir=os.path.join(td, "ckpt"), sinks=[sink])
        sink.close()
        trace = json.load(open(path))
        events = trace["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X"]
        metas = [e for e in events if e.get("ph") == "M"]
        assert spans and metas, "trace missing spans or thread metadata"
        thread_names = {e["args"]["name"] for e in metas}
        assert any("device-prefetch" in n for n in thread_names), thread_names
        by_name = {}
        for e in spans:
            by_name.setdefault(e["name"], []).append(e)
        for required in ("executor.dispatch", "prefetch.convert_transfer",
                         "checkpoint.save"):
            assert required in by_name, (required, sorted(by_name))
        # the structure: both span kinds on distinct threads, prefetch
        # begun before the last dispatch ends
        p_tids = {p["tid"] for p in by_name["prefetch.convert_transfer"]}
        d_tids = {d["tid"] for d in by_name["executor.dispatch"]}
        assert p_tids and d_tids and not (p_tids & d_tids), (
            "prefetch and dispatch spans share a thread", p_tids, d_tids)
        first_p = min(p["ts"] for p in by_name["prefetch.convert_transfer"])
        last_d = max(d["ts"] + d["dur"] for d in by_name["executor.dispatch"])
        assert first_p < last_d, (
            "prefetch never ran before the last dispatch finished")
        # wall-time overlap of a prefetch span with a dispatch span is
        # reported, not asserted: on a shared CPU box the GIL and the
        # other processes make it scheduler luck
        overlap = any(p["ts"] < d["ts"] + d["dur"]
                      and d["ts"] < p["ts"] + p["dur"]
                      for p in by_name["prefetch.convert_transfer"]
                      for d in by_name["executor.dispatch"])
        how = "structure OK, overlap %s" % ("seen" if overlap else "not seen")
    return ("chrome trace: %d spans on %d threads, %s OK"
            % (len(spans), len(thread_names), how))


def scenario_bitwise_neutrality():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.reader.device_prefetch import transfer_count

    with tempfile.TemporaryDirectory() as td:
        losses_on, losses_off = [], []
        sink = obs.RingBufferSink()
        copies0, transfers0 = fluid.executor.feed_host_copy_count(), transfer_count()
        w_on = _train(cdir=os.path.join(td, "c1"), sinks=[sink],
                      losses=losses_on)
        copies_on = fluid.executor.feed_host_copy_count() - copies0
        transfers_on = transfer_count() - transfers0
        copies0, transfers0 = fluid.executor.feed_host_copy_count(), transfer_count()
        w_off = _train(cdir=os.path.join(td, "c2"), sinks=[],
                       losses=losses_off)
        copies_off = fluid.executor.feed_host_copy_count() - copies0
        transfers_off = transfer_count() - transfers0
    assert w_on.tobytes() == w_off.tobytes(), (
        "telemetry changed trained parameters")
    assert losses_on == losses_off, "telemetry changed step losses"
    assert copies_on == copies_off, (
        "telemetry changed the feed-copy contract counter: %d vs %d"
        % (copies_on, copies_off))
    assert transfers_on == transfers_off, (
        "telemetry changed the transfer counter: %d vs %d"
        % (transfers_on, transfers_off))
    assert sink.records, "ring buffer sink captured nothing"
    return ("bitwise neutrality: params+losses identical, counters "
            "%d copies / %d transfers both runs OK"
            % (copies_on, transfers_on))


def main():
    failures = []
    for scenario in (scenario_jsonl_schema, scenario_chrome_trace,
                     scenario_bitwise_neutrality):
        try:
            msg = scenario()
        except AssertionError as e:
            failures.append("%s FAILED: %s" % (scenario.__name__, e))
        else:
            print(msg)
    if failures:
        for f in failures:
            sys.stderr.write(f + "\n")
        sys.stderr.write("\nobservability gate FAILED\n")
        return 1
    print("observability gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
