"""Runs the port's observability gate, tools/check_observability_torch.py
(the JSONL step-record schema through the port's Trainer, a Chrome trace
with prefetch-thread spans, sinks attached against detached bitwise), in
a clean subprocess on the CPU with a time limit of its own, and fails on
any regression."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_observability_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PADDLE_TPU_TELEMETRY", None)  # the gate needs telemetry on
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_observability_torch.py")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        "check_observability_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "observability gate OK" in proc.stdout
