"""Reading a run's numbers off the card, and the metrics JSONL (port of
splice_tpu/utils/metrics.py: fetch_stacked, MetricsLogger,
device_memory_stats, StepTimer).

A device value bound for the host leaves the loop's thread as a HostCopy:
one non-blocking copy into pinned host memory and a CUDA event recorded
behind it, both issued on the loop's thread. Whoever reads it (a worker
thread, or the loop a chunk later) waits on that event alone, so the read
neither waits behind the chunks queued after the copy nor makes the loop's
thread synchronise.
"""
from __future__ import annotations

import json
import pathlib
import queue
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class HostCopy:
    """A tensor on its way to the host. On CUDA: a non-blocking copy into
    pinned memory and the event recorded after it on the current stream of
    the tensor's device (neither synchronises); wait() blocks on that
    event alone. On the CPU: a clone, taken now (the source may be written
    again before the read)."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.device(t.device):   # t's stream, t's event
                self.host.copy_(t, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()
        else:
            self.host = t.clone()

    def wait(self) -> torch.Tensor:
        """The host tensor, once the copy has landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _stacked(values: Dict[str, Any]) -> torch.Tensor:
    """float32 [len(values)] of device scalars (one device) or host
    numbers."""
    return torch.stack([torch.as_tensor(v).float().reshape(())
                        for v in values.values()])


def fetch_stacked(device_data: Dict[str, torch.Tensor]
                  ) -> Tuple[List[str], np.ndarray]:
    """ONE stacked device-to-host copy for a dict of device scalars (or
    equal-shape tensors): each .item() would wait for the device on its
    own. Returns (keys, float32 ndarray stacked along axis 0)."""
    keys = list(device_data)
    vals = torch.stack([device_data[k].float() for k in keys]).cpu().numpy()
    return keys, vals


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock timing.

    log() writes synchronously; log_async() stacks the record's device
    scalars and issues their HostCopy on the caller's thread (no
    synchronisation there) and hands it to a worker thread, which waits on
    its event and writes the record. Any number of threads may call
    log_async (the worker is the single file writer, so records never
    interleave); a record is dropped rather than blocking when the queue is
    full. A record that fails is reported on stderr and counted in
    `errors`. Mixing log() with concurrent log_async is not supported (two
    writers on one file). close() drains the queue, stops the worker,
    closes the file, and is idempotent; log_async after close is a no-op.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()   # guards worker spawn against close
        self._closed = False
        self.errors = 0
        if path:
            pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self.t0 = time.perf_counter()

    def log(self, step: int, data: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        rec = {"step": step, "t": round(time.perf_counter() - self.t0, 4)}
        for k, v in data.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")

    def log_async(self, step: int, device_data: Dict[str, Any],
                  host_data: Optional[Dict[str, Any]] = None,
                  with_memory: bool = False) -> None:
        """Queue a record: device_data's values (device scalars of one
        device, or host numbers) are copied as one HostCopy, host_data's
        are written as given; with_memory adds device_memory_stats()."""
        if self._fh is None or self._closed:
            return
        if self._thread is None:
            with self._lock:
                # a concurrent close() may have won, or another producer
                # may have spawned the worker already
                if self._closed:
                    return
                if self._thread is None:
                    self._q = queue.Queue(maxsize=64)
                    self._thread = threading.Thread(target=self._run,
                                                    daemon=True)
                    self._thread.start()
        if self._q.full():
            return    # drop the record rather than stall the loop
        host = {"t": round(time.perf_counter() - self.t0, 4),
                **(host_data or {})}
        vals = HostCopy(_stacked(device_data))
        try:
            self._q.put_nowait((step, list(device_data), vals, host,
                                with_memory))
        except queue.Full:
            pass

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, keys, vals, host_data, with_memory = item
            try:
                fetched = dict(zip(keys, vals.wait().tolist()))
                mem = device_memory_stats() if with_memory else {}
                self.log(step, {**fetched, **host_data, **mem})
            except Exception:     # the worker outlives one bad record
                self.errors += 1
                traceback.print_exc(file=sys.stderr)
            finally:
                self._q.task_done()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._thread is not None:
            self._q.join()
            self._q.put(None)
            self._thread.join(timeout=10)
            self._thread = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def device_memory_stats() -> Dict[str, float]:
    """In-use, peak and total memory of the current CUDA device in MiB,
    under the reference's names (the caching allocator's allocated bytes,
    the graphs' pools included); empty where CUDA is not in use. Reads the
    allocator's counters only: no device synchronisation."""
    if not torch.cuda.is_initialized():
        return {}
    stats = torch.cuda.memory_stats()
    total = torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory
    mib = 1024 * 1024
    return {"hbm_in_use_mib": round(stats["allocated_bytes.all.current"]
                                    / mib, 1),
            "hbm_peak_mib": round(stats["allocated_bytes.all.peak"] / mib, 1),
            "hbm_limit_mib": round(total / mib, 1)}


class StepTimer:
    """Steps/sec over a run, host-side: tick(n) once n more steps are
    done (their results read)."""

    def __init__(self):
        self.last = time.perf_counter()
        self.count = 0
        self.elapsed = 0.0

    def tick(self, n: int = 1) -> float:
        """Count n steps; returns the seconds since the last tick."""
        now = time.perf_counter()
        dt = now - self.last
        self.elapsed += dt
        self.last = now
        self.count += n
        return dt

    def rate(self) -> float:
        return self.count / self.elapsed if self.elapsed > 0 else 0.0
