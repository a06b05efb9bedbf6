"""Runs the port's SLO gate, tools/check_slo_torch.py (self-healing under
chaos, the circuit breaker, dead-worker supervision, admission shedding,
SLO alerts and the autoscale signal), in a clean subprocess on the CPU
with a time limit of its own, and fails on any regression."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_slo_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PADDLE_TPU_TELEMETRY", None)  # the gate needs telemetry on
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_slo_torch.py")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        "check_slo_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "SLO gate OK" in proc.stdout
