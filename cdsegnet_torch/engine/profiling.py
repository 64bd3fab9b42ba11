"""The profiling hook (reference `RuntimeProfiler`,
`pointcept/engines/hooks/misc.py:315-464`).

Port of `cdsegnet_tpu/engine/profiling.py` over `torch.profiler`: a trace
of the training steps [wait, wait + active), written as a gzipped Chrome
trace at ``<save_path>/trace/plugins/profile/<run>/<host>.trace.json.gz``,
the layout that JAX's profiler writes and `summarize_trace` reads in both
packages; then the heaviest event names, logged as ``[profile] <ms> <name>``.
On the card the trace holds its activity (kernels, copies and the CUDA
calls that launched them), so that the summary ranks the kernels, as JAX's
ranks the device's fused ops; on the CPU it holds the host operators.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import shutil
import socket
import time

import torch

from cdsegnet_torch.engine.hooks import HOOKS, HookBase


def summarize_trace(trace_dir: str, top: int = 20):
    """``(name, microseconds)`` of the ``top`` event names by summed
    duration in the newest trace under ``trace_dir``."""
    files = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz")))
    if not files:
        return []
    with gzip.open(files[-1]) as f:
        data = json.load(f)
    tot = collections.Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e and not e.get("name", "$").startswith("$"):
            tot[e["name"]] += e["dur"]
    return tot.most_common(top)


@HOOKS.register_module()
class RuntimeProfiler(HookBase):
    """Trace the training steps [wait, wait + active): the trace starts
    before the step whose update count is ``wait`` and stops after the one
    that brings it to ``wait + active`` (or at the end of training). With
    ``log_summary`` the 20 heaviest event names are logged."""

    def __init__(self, wait: int = 2, active: int = 3, log_summary: bool = True):
        self.wait = wait
        self.active = active
        self.log_summary = log_summary
        self._prof = None

    @property
    def trace_dir(self) -> str:
        return os.path.join(self.trainer.save_path, "trace")

    def before_step(self):
        if self.trainer.step == self.wait and self._prof is None:
            on_card = torch.device(self.trainer.device).type == "cuda"
            activity = torch.profiler.ProfilerActivity.CUDA if on_card else \
                torch.profiler.ProfilerActivity.CPU
            self._prof = torch.profiler.profile(activities=[activity])
            self._prof.start()

    def after_step(self):
        if self._prof is not None and self.trainer.step >= self.wait + self.active:
            self._stop()
            if self.log_summary:
                for name, dur in summarize_trace(self.trace_dir):
                    self.trainer.logger.info(f"[profile] {dur / 1e3:9.2f} ms {name[:90]}")

    def after_train(self):
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        """Stop the trace and write it gzipped where `summarize_trace` looks."""
        if torch.device(self.trainer.device).type == "cuda":
            torch.cuda.synchronize(self.trainer.device)
        self._prof.stop()
        run = os.path.join(self.trace_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(run, exist_ok=True)
        path = os.path.join(run, f"{socket.gethostname()}.trace.json")
        self._prof.export_chrome_trace(path)
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(path)
        self._prof = None
