"""Runs the port's model router gate, tools/check_router_torch.py
(bitwise per model against dedicated pools, typed quota breaches with
the labeled counter, the 0.75/0.25 canary split exact to +/-1 and its
rollback, cold activation and LRU deactivation under live traffic with
zero dropped futures), in a clean subprocess on the CPU with a time
limit of its own, and fails on any regression.  What only the card has
(leased streams, captures under another pool's traffic, the device
memory a deactivation gives back) is chip_smoke.py's router phase."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_router_torch_gate():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PADDLE_TPU_TELEMETRY", None)  # the gate reads counters
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "tools", "check_router_torch.py")],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (
        "check_router_torch failed:\nstdout:\n%s\nstderr:\n%s"
        % (proc.stdout, proc.stderr))
    assert "model router gate OK" in proc.stdout
