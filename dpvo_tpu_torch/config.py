"""Configuration for the SLAM engine and training.

Field-for-field copy of ``dpvo_tpu/config.py`` (this package imports
nothing of ``dpvo_tpu``): a frozen dataclass, with YAML files and
``KEY VALUE`` CLI pairs merged into it (``--opts BUFFER_SIZE 8192``), so
``configs/*.yaml`` load unchanged.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class VOConfig:
    """Inference/SLAM engine configuration (defaults mirror ref config.py)."""

    # max number of keyframes
    BUFFER_SIZE: int = 4096

    # patch centroid selection: RANDOM | GRADIENT_BIAS
    CENTROID_SEL_STRAT: str = "RANDOM"

    # VO config
    PATCHES_PER_FRAME: int = 96
    REMOVAL_WINDOW: int = 22
    OPTIMIZATION_WINDOW: int = 10
    PATCH_LIFETIME: int = 13

    # keyframing
    KEYFRAME_INDEX: int = 4
    KEYFRAME_THRESH: float = 15.0
    # lagged keyframe decisions (the JAX engine's, made deterministic: a
    # batch of BATCH decisions applies once it is LAG frames overdue);
    # False is the reference's synchronous timing
    ASYNC_KEYFRAME: bool = True
    ASYNC_KEYFRAME_LAG: int = 8
    ASYNC_KEYFRAME_BATCH: int = 4

    # camera motion model
    MOTION_MODEL: str = "DAMPED_LINEAR"
    MOTION_DAMPING: float = 0.5

    # bf16 activations (the reference's CUDA fp16 AMP)
    MIXED_PRECISION: bool = True

    # proximity loop closure
    LOOP_CLOSURE: bool = False
    BACKEND_THRESH: float = 64.0
    MAX_EDGE_AGE: int = 1000
    GLOBAL_OPT_FREQ: int = 15

    # classic loop closure: DBoW retrieval + Sim3 PGO
    CLASSIC_LOOP_CLOSURE: bool = False
    LOOP_CLOSE_WINDOW_SIZE: int = 3
    LOOP_RETR_THRESH: float = 0.04
    LOOP_VOCAB_PATH: str = ""
    LOOP_MATCHER: str = "sift"

    # static edge-table capacities (0 = auto-size, see edge_capacity())
    EDGE_CAPACITY: int = 0
    EDGE_CAPACITY_INAC: int = 16384
    # pose-window capacity for local BA (0 = auto from OPTIMIZATION_WINDOW)
    BA_WINDOW_CAP: int = 0
    # smallest edge bucket of the JAX engine's shape ladder (unused by
    # the port, which runs at the live edge count)
    BUCKET_FLOOR: int = 8192
    # dtype used for feature ring buffers & network activations
    COMPUTE_DTYPE: str = "bfloat16"
    # correlation backend of the JAX engine (unused by the port)
    CORR_BACKEND: str = "auto"

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)

    def kf_shift_cap(self) -> int:
        """Ring-shift bound for compact_frames."""
        lag = self.ASYNC_KEYFRAME_LAG if self.ASYNC_KEYFRAME else 0
        return self.KEYFRAME_INDEX + lag + 1

    def edge_capacity(self) -> int:
        """Resolved active edge-table capacity: EDGE_CAPACITY, or for 0 the
        no-merge steady state M*(2L-1)*(RW+1) (+4096 with loop closure)
        rounded up to a multiple of 4096."""
        if self.EDGE_CAPACITY:
            return self.EDGE_CAPACITY
        per_frame = self.PATCHES_PER_FRAME * (2 * self.PATCH_LIFETIME - 1)
        need = per_frame * (self.REMOVAL_WINDOW + 1)
        if self.LOOP_CLOSURE:
            need += 4096
        return -(-need // 4096) * 4096

    def merge_opts(self, opts: list[str] | None) -> "VOConfig":
        """Merge ``[KEY, VALUE, KEY, VALUE, ...]`` CLI pairs (yacs-style)."""
        if not opts:
            return self
        if len(opts) % 2:
            raise ValueError("opts must be KEY VALUE pairs")
        kw: dict[str, Any] = {}
        for k, v in zip(opts[::2], opts[1::2]):
            cur = getattr(self, k)  # raises for unknown keys, like yacs
            if isinstance(cur, bool):
                kw[k] = str(v).lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                kw[k] = int(v)
            elif isinstance(cur, float):
                kw[k] = float(v)
            else:
                kw[k] = v
        return self.replace(**kw)

    def merge_yaml(self, path: str) -> "VOConfig":
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(self)}
        return self.replace(**{k: v for k, v in data.items() if k in known})


def load_train_config(path: str) -> dict:
    """Training config: nested YAML dict with defaults in the sections
    dataset/training/scheduler/model/loss/dataloader/validation; a user
    section updates its defaults key by key (``train.py``'s loader)."""
    import yaml
    defaults: dict[str, Any] = {
        "dataset": {"names": ["tartan"], "roots": ["datasets/TartanAir"],
                    "n_frames": 15, "fmin": 16.0, "fmax": 60.0},
        "training": {"steps": 240000, "lr": 8e-5, "weight_decay": 1e-6,
                     "clip": 10.0, "batch_size": 1, "ckpt": None,
                     "name": "dpvo_tpu", "iters": 18, "M": 80,
                     "structure_warmup": 1000},
        "scheduler": {"type": "onecycle", "pct_start": 0.01},
        "model": {"patch_size": 3, "dim": 384},
        "loss": {"flow_weight": 10.0, "pose_weight": 10.0,
                 "so_weight": 1.0},
        "dataloader": {"num_workers": 8, "prefetch": 4},
        "validation": {"freq": 5000, "n_frames": 15},
    }
    with open(path) as f:
        user = yaml.safe_load(f) or {}
    for k, v in user.items():
        if isinstance(v, dict) and k in defaults:
            defaults[k].update(v)
        else:
            defaults[k] = v
    return defaults
