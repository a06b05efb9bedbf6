"""Runs the port's decode gate, tools/check_decode_torch.py (continuous
batching == per-sequence, admission contracts, telemetry, chunked
prefill, the prefix cache), in a clean subprocess on the CPU with a time
limit of its own, and fails on any regression."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_decode_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PADDLE_TPU_TELEMETRY", None)  # the gate needs telemetry on
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_decode_torch.py")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        "check_decode_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "decode gate OK" in proc.stdout
