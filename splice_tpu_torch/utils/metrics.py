"""Reading a step's numbers off the card (port of
splice_tpu/utils/metrics.py:13-23,144-164: fetch_stacked and StepTimer;
the JSONL MetricsLogger is not ported yet)."""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch


def fetch_stacked(device_data: Dict[str, torch.Tensor]
                  ) -> Tuple[List[str], np.ndarray]:
    """ONE stacked device-to-host copy for a dict of device scalars (or
    equal-shape tensors): each .item() would wait for the device on its
    own. Returns (keys, float32 ndarray stacked along axis 0)."""
    keys = list(device_data)
    vals = torch.stack([device_data[k].float() for k in keys]).cpu().numpy()
    return keys, vals


class StepTimer:
    """Steps/sec over a run, host-side: tick(n) after each dispatch of n
    steps, once its results are read."""

    def __init__(self):
        self.last = time.perf_counter()
        self.count = 0
        self.elapsed = 0.0

    def tick(self, n: int = 1) -> None:
        now = time.perf_counter()
        self.elapsed += now - self.last
        self.last = now
        self.count += n

    def rate(self) -> float:
        return self.count / self.elapsed if self.elapsed > 0 else 0.0
