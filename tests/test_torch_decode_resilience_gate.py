"""Runs the port's durable-decode gate,
tools/check_decode_resilience_torch.py (a replica killed mid-decode
replayed bitwise on its siblings, KV corruption isolated, a decode
dispatch's fault kept to its own sequences, cancellation, the replay
budget, the reset_pools guard), in a clean subprocess on the CPU with a
time limit of its own, and fails on any regression."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_decode_resilience_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PADDLE_TPU_TELEMETRY", None)  # the gate reads counters
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "tools", "check_decode_resilience_torch.py")],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (
        "check_decode_resilience_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "decode resilience gate OK" in proc.stdout
