"""SLAM engine state: device tensors at fixed capacity + host bookkeeping.

Counterpart of ``dpvo_tpu/engine/state.py``.  Device tensors are allocated
once at capacity and updated in place (the port mutates where JAX
rebuilt arrays):

- frame tables at BUFFER_SIZE (poses, patches, intrinsics, colors);
- feature rings at ``mem`` / ``pmem`` slots (fmap pyramid, gmap, imap);
  the fmap rings are stored zero-padded (``ops.corr_cuda.padded_hw``) so
  the correlation kernel reads whole tap windows with no bounds logic;
- the active edge table (hidden state, target, weight, and device twins
  of the host ii/jj/kk) with the first ``e_num`` rows live;
- the inactive edge store of global BA (loop closure): the target and
  weight rows of retired edges, the first ``n_inac`` live.

The host owns the edge bookkeeping (numpy), the inactive edges' indices
included.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..config import VOConfig
from ..models.update import DIM
from ..ops.corr_cuda import padded_hw


@dataclass
class DeviceState:
    poses: Any        # (N, 7) f32 — world-from-camera (inverse poses)
    patches: Any      # (N*M, 3, P, P) f32
    intrinsics: Any   # (N, 4) f32 at feature resolution
    colors: Any       # (N, M, 3) u8

    imap: Any         # (pmem*M, DIM) ctype
    gmap: Any         # (pmem*M, P, P, 128) ctype
    fmap1: Any        # (mem, Hp1, Wp1, 128) ctype, zero-padded
    fmap2: Any        # (mem, Hp2, Wp2, 128) ctype, zero-padded

    net: Any          # (E_cap, DIM) f32 — edge hidden state
    target: Any       # (E_cap, 2) f32
    weight: Any       # (E_cap, 2) f32
    eii: Any          # (E_cap,) i32
    ejj: Any          # (E_cap,) i32
    ekk: Any          # (E_cap,) i32

    target_inac: Any  # (EDGE_CAPACITY_INAC, 2) f32 — retired edges
    weight_inac: Any  # (EDGE_CAPACITY_INAC, 2) f32


@dataclass
class HostState:
    n: int = 0                 # number of keyframes
    m: int = 0                 # number of patches
    counter: int = 0           # frames seen (including non-keyframed)
    tlist: list = field(default_factory=list)
    tstamps: np.ndarray | None = None          # (N,) int64 counter per slot
    ii: np.ndarray | None = None               # (E_cap,) first e_num live
    jj: np.ndarray | None = None
    kk: np.ndarray | None = None
    e_num: int = 0
    # the inactive edge store (global BA): indices here, target/weight
    # rows on the device; n_inac rows filled
    ii_inac: np.ndarray | None = None
    jj_inac: np.ndarray | None = None
    kk_inac: np.ndarray | None = None
    n_inac: int = 0
    # relative poses of removed frames: {t1: (t0, dP (7,) tensor)}
    delta: dict = field(default_factory=dict)


def allocate(cfg: VOConfig, ht: int, wd: int, P: int, pmem: int, mem: int,
             device: torch.device, ctype: torch.dtype) -> DeviceState:
    N = cfg.BUFFER_SIZE
    M = cfg.PATCHES_PER_FRAME
    E = cfg.edge_capacity()
    h, w = ht // 4, wd // 4

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    poses = z(N, 7)
    poses[:, 6] = 1.0
    return DeviceState(
        poses=poses,
        patches=z(N * M, 3, P, P),
        intrinsics=z(N, 4),
        colors=z(N, M, 3, dtype=torch.uint8),
        imap=z(pmem * M, DIM, dtype=ctype),
        gmap=z(pmem * M, P, P, 128, dtype=ctype),
        fmap1=z(mem, *padded_hw(h, w), 128, dtype=ctype),
        fmap2=z(mem, *padded_hw(h // 4, w // 4), 128, dtype=ctype),
        net=z(E, DIM),
        target=z(E, 2),
        weight=z(E, 2),
        eii=z(E, dtype=torch.int32),
        ejj=z(E, dtype=torch.int32),
        ekk=z(E, dtype=torch.int32),
        target_inac=z(cfg.EDGE_CAPACITY_INAC, 2),
        weight_inac=z(cfg.EDGE_CAPACITY_INAC, 2),
    )


def allocate_host(cfg: VOConfig) -> HostState:
    E = cfg.edge_capacity()
    hs = HostState()
    hs.tstamps = np.zeros((cfg.BUFFER_SIZE,), np.int64)
    hs.ii = np.zeros((E,), np.int32)
    hs.jj = np.zeros((E,), np.int32)
    hs.kk = np.zeros((E,), np.int32)
    hs.ii_inac = np.zeros((0,), np.int32)
    hs.jj_inac = np.zeros((0,), np.int32)
    hs.kk_inac = np.zeros((0,), np.int32)
    return hs
