"""Runs the port's serving gate, tools/check_serving_torch.py (bitwise
batched-vs-unbatched equality on the Program and AOT backends, deadline
and backpressure behavior, hot swap with drain under load, the serving.*
telemetry schema), in a clean subprocess on the CPU with a time limit of
its own, and fails on any regression."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serving_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PADDLE_TPU_TELEMETRY", None)  # the gate needs telemetry on
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_serving_torch.py")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        "check_serving_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "serving gate OK" in proc.stdout
