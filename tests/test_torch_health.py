"""The port's step watchdog (mxnet_tpu_torch/health.py), the liveness
half of mxnet_tpu/health.py: a stalled loop gets its stacks dumped to a
JSON artifact in the JAX package's schema (tools/diagnose.py renders
it) and StepHung delivered into the watched thread; kicks and a pause
keep it quiet."""
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from mxnet_tpu_torch import health
from mxnet_tpu_torch.base import MXNetError, StepHung

TOOL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "tools", "diagnose.py")


def test_watchdog_dumps_and_raises_step_hung(tmp_path):
    wd = health.StepWatchdog(0.2, stats_cb=lambda: {"step": 7},
                             dump_dir=str(tmp_path)).start()
    try:
        with pytest.raises(StepHung):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        wd.stop()
    assert wd.fired and wd.dump_path.startswith(str(tmp_path))
    assert wd.target is threading.current_thread()
    assert wd.fired_note == "startup (no step dispatched yet)"
    payload = json.loads(open(wd.dump_path).read())
    assert payload["kind"] == "mxnet_tpu-watchdog-dump"
    assert payload["health"] == {"step": 7}
    assert "test_watchdog_dumps_and_raises_step_hung" in \
        payload["traceback"]
    assert health.last_hang_details()["dump_path"] == wd.dump_path
    res = subprocess.run([sys.executable, TOOL, wd.dump_path],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr


def test_watchdog_kick_pause_and_validation(tmp_path):
    with pytest.raises(MXNetError, match="> 0"):
        health.StepWatchdog(0)
    # a 1 s timeout: a 50 ms sleep stays far inside it on a loaded CPU
    wd = health.StepWatchdog(1.0, dump_dir=str(tmp_path)).start()
    try:
        for _ in range(8):  # kicked well inside the timeout: never fires
            time.sleep(0.05)
            wd.kick("step")
        wd.pause()  # paused across a long stretch: never fires
        time.sleep(1.5)
        assert not wd.fired and wd.alive
    finally:
        wd.stop()
    assert not wd.alive
    assert not any(t.name.startswith(health.WATCHDOG_THREAD_PREFIX)
                   for t in threading.enumerate())
