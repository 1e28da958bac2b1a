"""The multi-pair trainer's ("dp", "tp") device mesh and the ViT's
tensor-parallel layout (port of splice_tpu/parallel/mesh.py and of the mesh
resolution in splice_tpu/parallel/pair_parallel.py:310-334).

dp shards the pairs: each dp group trains its own pairs with nothing
shared but the frozen ViT's weights. tp shards the frozen ViT
Megatron-style: qkv and fc1 column-parallel (their output dim split over
the ranks), proj and fc2 row-parallel (their input dim split), everything
else whole on every rank; models.vit runs a rank's heads and MLP slice on
its device and adds the row-parallel partial sums on the group's first
device.

As in the reference, one process drives the whole mesh. A mesh is a
[dp][tp] grid of torch devices. The devices may repeat where the caller
lists them so (the CPU tests' ['cpu'] * 8, the reference's virtual 8-CPU
mesh; a sharded program on one card): the reductions are then adds on one
device, and they give the numbers that copies between devices give.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices[g][r]: tp rank r of dp group g."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}


def make_mesh(dp: int = 1, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A dp x tp grid over `devices` in list order (default every visible
    CUDA device, cuda:0..n-1); ValueError when dp x tp needs more devices
    than the list holds (:36-38). A device may be listed more than once."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if dp < 1 or tp < 1 or dp * tp > len(devices):
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, "
                         f"have {len(devices)}")
    return Mesh(tuple(tuple(devices[g * tp:(g + 1) * tp])
                      for g in range(dp)))


def visible_devices(device: torch.device) -> int:
    """The devices a run on `device` can see: the CUDA device count, or 1
    on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def resolve_mesh(cfg, n_pairs: int, n_devices: int) -> Tuple[int, int]:
    """(dp, tp) for cfg.mesh_dp x cfg.mesh_tp over n_pairs pairs and
    n_devices devices, clamped as the reference clamps them (tp to the
    devices; dp to n_devices // tp; dp to the largest divisor of n_pairs
    that is at most dp), each clamp announced in the reference's words."""
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
    return dp, tp


def _spec_tree(tree: Any, path: str) -> Any:
    if isinstance(tree, dict):
        return {k: _spec_tree(v, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_spec_tree(v, f"{path}.{i}") for i, v in enumerate(tree)]
    if path.endswith(("qkv.kernel", "fc1.kernel")):
        return 1                    # column-parallel: P(None, "tp")
    if path.endswith(("qkv.bias", "fc1.bias")):
        return 0                    # P("tp")
    if path.endswith(("proj.kernel", "fc2.kernel")):
        return 0                    # row-parallel: P("tp", None)
    return None                     # replicated: P()


def vit_param_pspecs(params: Dict[str, Any]) -> Any:
    """The reference's Megatron layout (:44-63) as slicing rules: for each
    leaf of the ViT's parameter tree, the dim split over the tp ranks
    (qkv and fc1 kernels 1, their biases 0; proj and fc2 kernels 0), or
    None where every rank holds the whole tensor."""
    return _spec_tree(params, "")


def manual_tp_permute_vit_params(params: Dict[str, Any], cfg,
                                 tp: int) -> Dict[str, Any]:
    """Permute each block's fused qkv columns shard-major (:66-98): the
    stored [D, 3D] kernel is [q (every head) | k | v]; regrouping [D, 3, H,
    dh] as [D, tp, 3, H/tp, dh] makes the contiguous 1/tp column chunk r
    rank r's own [q_r | k_r | v_r] over its H/tp heads. proj, fc1 and fc2
    need no permutation."""
    if tp == 1:
        return params
    H, dh, D = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    if H % tp:
        raise ValueError(f"manual tp={tp} must divide num_heads={H}")

    def permute_block(blk):
        qkv = blk["attn"]["qkv"]
        k = (qkv["kernel"].reshape(D, 3, tp, H // tp, dh)
             .permute(0, 2, 1, 3, 4).reshape(D, 3 * D))
        b = (qkv["bias"].reshape(3, tp, H // tp, dh)
             .permute(1, 0, 2, 3).reshape(3 * D))
        return {**blk, "attn": {**blk["attn"],
                                "qkv": {"kernel": k, "bias": b}}}

    return {**params, "blocks": [permute_block(b) for b in params["blocks"]]}


def _tree_zip_map(fn, tree: Any, specs: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_vit_params(params: Dict[str, Any], mesh: Mesh
                     ) -> List[List[Dict[str, Any]]]:
    """[dp][tp] parameter trees: rank r's slice of every leaf under
    vit_param_pspecs (chunk r of the split dim; the whole tensor where
    replicated), on mesh.devices[g][r]. Replicated over dp: groups on the
    same devices share their tensors, and a replicated leaf already on a
    rank's device is that tensor. For the manual tp form pass the params
    through manual_tp_permute_vit_params first."""
    specs = vit_param_pspecs(params)
    tp = mesh.tp

    def rank_slice(r: int, dev: torch.device):
        def f(t, dim):
            if dim is not None:
                n = t.shape[dim] // tp
                t = t.narrow(dim, r * n, n).contiguous()
            return t.to(dev)
        return _tree_zip_map(f, params, specs)

    made: Dict[Tuple[torch.device, ...], List[Dict[str, Any]]] = {}
    for row in mesh.devices:
        if row not in made:
            made[row] = [rank_slice(r, d) for r, d in enumerate(row)]
    return [made[row] for row in mesh.devices]


def dp_sharding(mesh: Mesh, n: int) -> List[range]:
    """The leading axis of n pairs split over dp (:109-111): group g's
    pair indices. dp must divide n (resolve_mesh makes it)."""
    if n % mesh.dp:
        raise ValueError(f"dp={mesh.dp} does not divide {n} pairs")
    k = n // mesh.dp
    return [range(g * k, (g + 1) * k) for g in range(mesh.dp)]
