"""Checkpoint and resume (port of splice_tpu/utils/checkpoint.py).

A checkpoint is one torch.save file, <directory>/ckpt_<step>.pt, holding a
run's state as a dict of named entries (tensors, numbers and nested dicts
of them), restored by name. save() copies the state to the host on the
caller's thread, which waits for the device once, and writes the file on
a writer thread: to a temp file first, then os.replace, so a crash never
leaves a truncated checkpoint at a final name. The newest max_to_keep
files stay.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


def _to_host(obj: Any) -> Any:
    """A copy of `obj` with every tensor on the host (the source keeps
    changing after save returns)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Copy `state` to the host now (this waits for the device: once
        per save) and write it on the writer thread, after the previous
        save's write."""
        host = _to_host(state)
        self.wait()
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host))
        self._thread.start()

    def _write(self, step: int, host: Dict[str, Any]) -> None:
        try:
            final = self.path(step)
            tmp = f"{final}.tmp{os.getpid()}"
            torch.save(host, tmp)
            os.replace(tmp, final)
            if self.max_to_keep > 0:
                for old in self.steps()[:-self.max_to_keep]:
                    os.remove(self.path(old))
        except BaseException as e:    # raised again by wait()
            self._error = e

    def wait(self) -> None:
        """Block until the last save is on disk; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def steps(self) -> list:
        """The steps of the checkpoints on disk, ascending."""
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The state saved at `step` (default the latest), on the host."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
