"""Typed configuration for splice_tpu_torch.

The port's own copy of splice_tpu/config.py: the same flat YAML key set
(reference conf/default/config.yaml) and the same CLI > YAML > default
precedence. Knobs that only mean something to XLA or a TPU mesh are gone;
knobs for parts not yet ported are refused by validate() instead of being
silently ignored.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Optional

import yaml

# generator_conv values (the reference's, splice_tpu/config.py:81-85).
GENERATOR_CONVS = ("auto", "xla", "pallas", "fused")
GENERATOR_LAYOUTS = ("chw", "nhwc")
# the reference's values of init_type, scheduler_policy and optimizer
# (splice_tpu/config.py:150-154)
INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")
SCHEDULER_POLICIES = ("linear", "step", "plateau", "cosine", "none")
OPTIMIZERS = ("adam", "rmsprop", "sgd")


@dataclasses.dataclass
class Config:
    # --- reference-parity keys (conf/default/config.yaml) ---
    seed: int = -1                      # -1 -> random seed
    dataroot: str = "./datasets/splicing/cows"
    direction: str = "AtoB"             # AtoB | BtoA
    A_resize: int = -1                  # shorter-side resize of A, -1 = off
    B_resize: int = -1
    use_augmentations: bool = True

    global_A_crops_n_crops: int = 1
    global_A_crops_min_cover: float = 0.95
    global_B_crops_n_crops: int = 1
    global_B_crops_min_cover: float = 0.95

    init_type: str = "xavier"           # normal | xavier | kaiming | orthogonal
    init_gain: float = 0.02

    lambda_global_cls: float = 10.0
    lambda_global_ssim: float = 1.0
    lambda_global_identity: float = 1.0
    entire_A_every: int = 75
    lambda_entire_cls: float = 10.0
    lambda_entire_ssim: float = 1.0

    dino_model_name: str = "dino_vitb8"
    dino_global_patch_size: int = 224   # loss-side resize target

    cls_warmup: int = 1
    n_epochs: int = 10000
    scheduler_policy: str = "none"      # linear | step | plateau | cosine | none
    scheduler_n_epochs_decay: int = 8
    scheduler_lr_decay_iters: int = 300

    optimizer: str = "adam"             # adam | rmsprop | sgd
    optimizer_beta1: float = 0.0
    optimizer_beta2: float = 0.99
    lr: float = 2e-3

    log_images_freq: int = 10

    # --- the reference's run keys (splice_tpu/config.py:106-125) ---
    # Checkpoint every checkpoint_every steps into checkpoint_dir (0 or no
    # directory: off); resume_from: a checkpoint directory to continue
    # from (its latest step).
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    resume_from: Optional[str] = None
    # With max_restarts > 0 (and checkpointing on) the CLI runs the
    # training in a child process and relaunches it from the latest
    # checkpoint after a crash, up to this many times.
    max_restarts: int = 0
    # Raise after crossing this step on the first attempt only (tests the
    # relaunch); -1 = off.
    fault_inject_step: int = -1
    metrics_path: Optional[str] = None  # None -> <dataroot>/out/metrics.jsonl
    # Video mode (splice_tpu/config.py:133-138): <dataroot>/A holds the
    # frames in name order, B the appearance image; each frame after the
    # first starts from the previous frame's parameters. Warm frames render
    # and log once, at their end, unless video_log_frames_only is off.
    video_mode: bool = False
    video_log_frames_only: bool = True
    # Multi-pair training (splice_tpu/config.py:126-130): a comma-separated
    # dataroot trains its pairs together in one step
    # (parallel.pair_parallel.train_pairs). mesh_dp shards the pairs over
    # devices and mesh_tp the ViT; the port runs one device and raises
    # where the clamped mesh would need more (parallel.mesh).
    n_pairs: int = 1
    mesh_dp: int = 1
    mesh_tp: int = 1

    # --- port knobs ---
    # Frozen-ViT weights: a .npz written by splice_tpu's save_vit_params, or
    # a DINO torch state dict (.pth/.pt). None -> seeded random init.
    vit_weights: Optional[str] = None
    vit_compute_dtype: str = "bfloat16"
    generator_compute_dtype: str = "bfloat16"
    crop_canvas: int = 0                # 0 -> min(H, W) rounded down to 32
    antialias: bool = True
    dino_global_max_size: int = 480
    # How the generator's convs run (the reference's key and values):
    # auto = the per-site kernel rule, xla = F.conv2d everywhere, pallas =
    # the conv kernels everywhere, fused = BatchNorm apply + activation in
    # the conv kernels' input prologue (models/unet.skip_apply_chw).
    generator_conv: str = "auto"
    # The generator's layout (the reference's key, splice_tpu/config.py:80):
    # chw = models/unet.skip_apply_chw, routed by generator_conv; nhwc =
    # models/unet.skip_apply, every conv F.conv2d on the channels_last
    # view (XLA's conv in the reference).
    generator_layout: str = "chw"
    device: str = "cuda"

    def validate(self) -> "Config":
        checks = {
            "direction": ("AtoB", "BtoA"),
            "init_type": INIT_TYPES,
            "scheduler_policy": SCHEDULER_POLICIES,
            "optimizer": OPTIMIZERS,
            "vit_compute_dtype": ("bfloat16", "float32"),
            "generator_compute_dtype": ("bfloat16", "float32"),
            "generator_conv": GENERATOR_CONVS,
            "generator_layout": GENERATOR_LAYOUTS,
        }
        for name, allowed in checks.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r} is not "
                                 f"supported by the port; one of {allowed}")
        if self.global_A_crops_n_crops < 1 or self.global_B_crops_n_crops < 1:
            raise ValueError("crop counts must be >= 1")
        for cover in (self.global_A_crops_min_cover,
                      self.global_B_crops_min_cover):
            if not 0.0 < cover <= 1.0:
                raise ValueError(f"min_cover {cover} outside (0, 1]")
        return self


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _coerce(name: str, value: Any) -> Any:
    f = _FIELDS[name]
    t = str(f.type)
    if value is None:
        if "Optional" not in t:
            raise ValueError(f"config key {name!r} is null but has "
                             f"non-optional type {t}")
        return None
    if t == "int":
        return int(value)
    if t == "float":
        return float(value)
    if t == "bool":
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if t == "str":
        return str(value)
    return value


def load_config(path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Config:
    """Build a Config from (optional) YAML + (optional) override dict."""
    data: dict = {}
    if path is not None:
        with open(path) as f:
            data.update(yaml.safe_load(f) or {})
    if overrides:
        data.update({k: v for k, v in overrides.items() if v is not None})
    unknown = set(data) - set(_FIELDS)
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return Config(**{k: _coerce(k, v) for k, v in data.items()}).validate()


def add_cli_args(parser) -> None:
    """Register every config field as a --flag (CLI > YAML > default)."""
    for f in dataclasses.fields(Config):
        parser.add_argument(f"--{f.name}", type=str, default=None)


def config_from_cli(args, config_path: Optional[str] = None) -> Config:
    overrides = {f.name: getattr(args, f.name, None)
                 for f in dataclasses.fields(Config)}
    path = config_path
    default = pathlib.Path("conf/default/config.yaml")
    if path is None and default.exists():
        path = str(default)
    return load_config(path, overrides)
