"""Device traces (port of splice_tpu/utils/profiling.py).

torch.profiler in place of jax.profiler: a trace exported as Chrome/Perfetto
JSON into a directory (tools/trace_agg.py sums it by kernel). device_only is
the reference's device_trace_options (:12-20, no Python and no host tracer):
on CUDA the trace records the card's activity alone (kernels, copies,
memsets, those inside CUDA graph replays too), on the CPU the operators that
ran there, which are that device's work.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile


def trace_activities(device_only: bool, device="cuda"):
    """What a trace records: the device's activity alone with device_only,
    else the host's operators and the card's."""
    on_cuda = torch.device(device).type == "cuda"
    if device_only:
        return [ProfilerActivity.CUDA if on_cuda else ProfilerActivity.CPU]
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])


def start_trace(device_only: bool = True, device="cuda") -> profile:
    prof = profile(activities=trace_activities(device_only, device))
    prof.start()
    return prof


def stop_trace(prof: profile, profile_dir: str) -> str:
    """Stop `prof` and export its trace into profile_dir; returns the
    file's path."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], device_only: bool = True,
                device="cuda") -> Iterator[Optional[profile]]:
    """A device trace of the block into profile_dir if set, else nothing.
    The block must end with the device's work done (a synchronise or a
    read), or the trace misses its tail."""
    if not profile_dir:
        yield None
        return
    prof = start_trace(device_only, device)
    try:
        yield prof
    finally:
        stop_trace(prof, profile_dir)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TraceWindow:
    """A trace of steps [start, start + n) of a chunked loop into
    profile_dir (the reference's trainer, splice_tpu/trainer.py:708-714):
    the loop's chunk plan ends a chunk at both marks, and the loop calls
    at(step) before it queues the chunk that starts at `step`. At the first
    mark the device drains and the trace starts, at the second the device
    drains and the trace stops, so the trace holds exactly the window's
    steps. Nothing else waits for the device. `path` is the exported
    file, or None before the window closes."""

    def __init__(self, profile_dir: str, start: int, n: int, device):
        self.profile_dir, self.device = profile_dir, device
        self.start, self.stop = start, start + n
        self.prof: Optional[profile] = None
        self.path: Optional[str] = None

    def at(self, step: int) -> None:
        if step == self.start and self.path is None and self.prof is None:
            synchronize(self.device)
            self.prof = start_trace(True, self.device)
        elif step == self.stop:
            self.close()

    def close(self) -> None:
        """Stop the trace if it runs (the loop's end, or the stop mark)."""
        if self.prof is not None:
            synchronize(self.device)
            self.path = stop_trace(self.prof, self.profile_dir)
            self.prof = None
