"""Runs the port's resilience gate, tools/check_resilience_torch.py (a
torn checkpoint write and a corrupted newest serial, then a bitwise
resume; the NaN step guard), in a clean subprocess on the CPU with a
time limit of its own, and fails on any regression."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_resilience_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_resilience_torch.py")],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (
        "check_resilience_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "resilience gate OK" in proc.stdout
