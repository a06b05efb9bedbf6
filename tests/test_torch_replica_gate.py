"""Runs the port's replica pool gate, tools/check_replica_pool_torch.py
(pool == single engine bitwise on both backends, >= 2.5x scaling under
the service-delay shim, the rolling swap never at 0 ready replicas, and
kill / eject / revive), in a clean subprocess on the CPU with a time
limit of its own, and fails on any regression."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_replica_pool_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PADDLE_TPU_TELEMETRY", None)  # the gate reads counters
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "tools", "check_replica_pool_torch.py")],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (
        "check_replica_pool_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "replica pool gate OK" in proc.stdout
