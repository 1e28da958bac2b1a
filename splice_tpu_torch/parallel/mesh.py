"""The multi-pair trainer's device mesh (port of the mesh resolution in
splice_tpu/parallel/pair_parallel.py:310-334).

The reference lays its pairs over a ("dp", "tp") mesh: dp shards the pairs
(each pair's generator and optimizer state on its shard), tp shards the
frozen ViT Megatron-style. It clamps the requested mesh to the devices it
sees, so a configuration written for a slice still runs on one chip. The
port resolves the mesh by the same rule and runs dp = tp = 1, one device;
where the clamped mesh still asks for more, it raises instead of running
on fewer devices than the configuration names.
"""
from __future__ import annotations

from typing import Tuple

import torch


def visible_devices(device: torch.device) -> int:
    """The devices a run on `device` can see: the CUDA device count, or 1
    on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def resolve_mesh(cfg, n_pairs: int, n_devices: int) -> Tuple[int, int]:
    """(dp, tp) for cfg.mesh_dp x cfg.mesh_tp over n_pairs pairs and
    n_devices devices, clamped as the reference clamps them (tp to the
    devices; dp to n_devices // tp; dp to the largest divisor of n_pairs
    that is at most dp), each clamp announced in the reference's words.
    Raises NotImplementedError when dp or tp is still above 1: the port
    trains every pair on one device (dp over GPUs and the tensor-parallel
    ViT are the rest of ROADMAP A10)."""
    dp = min(cfg.mesh_dp, n_pairs) or 1
    tp = cfg.mesh_tp or 1
    if tp > n_devices:
        print(f"mesh tp={tp} exceeds {n_devices} visible device(s); "
              f"running tp=1")
        tp = 1
    if dp * tp > n_devices:
        dp_clamped = max(n_devices // tp, 1)
        print(f"mesh dp={dp} tp={tp} needs {dp * tp} devices, have "
              f"{n_devices}; clamping dp to {dp_clamped} (pairs still "
              f"optimize together in one compiled step)")
        dp = dp_clamped
    if n_pairs % dp != 0:
        dp_div = max(d for d in range(1, dp + 1) if n_pairs % d == 0)
        print(f"dp={dp} does not divide {n_pairs} pairs; using dp={dp_div}")
        dp = dp_div
    if dp > 1 or tp > 1:
        raise NotImplementedError(
            f"mesh dp={dp} tp={tp} over {n_devices} devices: the port trains "
            f"its pairs on one device; dp over several GPUs and the "
            f"tensor-parallel ViT are not ported yet (ROADMAP A10)")
    return dp, tp
