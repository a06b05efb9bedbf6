"""Runs the port's sessions gate, tools/check_sessions_torch.py (warm
turns bitwise cold re-prefills with fewer prefill tokens and no page
leaked, sticky affinity against least-loaded, the session owner killed
mid-turn, affinity against health, and prefill/decode roles through the
host-staged handoff), in a clean subprocess on the CPU with a time limit
of its own, and fails on any regression."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sessions_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PADDLE_TPU_TELEMETRY", None)  # the gate reads counters
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "tools", "check_sessions_torch.py")],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (
        "check_sessions_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "sessions gate OK" in proc.stdout
