"""Synthetic map-and-scan scenes at a path's shapes, from a seed, for
holding the update's kernels against their twins (``chip_smoke.py``,
``tests/test_torch_cuda.py``).

A scene is P particles near the origin sharing a landmark layout: 3K/4 live
features per particle scattered about the shared sites within the sensor
range, covariances 0.05 I + A A', weights in [0.05, 1) except the first
four at 25 (their persistent lanes outweigh any detection copy, so they
head their columns under pre-consolidation), and n_valid of M
measurements of sites drawn twice over (several copies per feature), with
twice the sensor noise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..filters.phd import _detection_planes, _update_pre
from ..kernels.merge import tables_operands
from ..models import measurement
from ..ops import ekf


class Scene(NamedTuple):
    pose: torch.Tensor       # [P, 6]
    mean: torch.Tensor       # [P, K, 2]
    cov: torch.Tensor        # [P, K, 2, 2]
    weight: torch.Tensor     # [P, K]
    z: torch.Tensor          # [M, 2]
    z_mask: torch.Tensor     # [M] bool


def map_scene(cfg: SlamConfig, P: int, K: int, M: int, n_valid: int,
              seed: int = 0, device="cpu") -> Scene:
    rng = np.random.default_rng(seed)
    n_live = 3 * K // 4
    sites = rng.uniform(-0.7, 0.7, (n_live, 2)) * cfg.max_range
    mean = np.zeros((P, K, 2))
    mean[:, :n_live] = sites + rng.normal(0, 0.3, (P, n_live, 2))
    A = rng.normal(0, 0.4, (P, K, 2, 2))
    cov = np.einsum("pkij,pklj->pkil", A, A) + 0.05 * np.eye(2)
    w = np.where(np.arange(K) < n_live, rng.uniform(0.05, 1.0, (P, K)), 0.0)
    w[:, :4] = 25.0
    d = sites[rng.integers(0, max(1, n_valid // 2), n_valid)]
    z = np.zeros((M, 2))
    z[:n_valid, 0] = np.hypot(d[:, 0], d[:, 1]) \
        + rng.normal(0, 2 * cfg.std_range, n_valid)
    z[:n_valid, 1] = np.arctan2(d[:, 1], d[:, 0]) \
        + rng.normal(0, 2 * cfg.std_bearing, n_valid)
    pose = np.zeros((P, 6))
    pose[:, :2] = rng.normal(0, 0.1, (P, 2))

    def f(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return Scene(f(pose), f(mean), f(cov), f(w), f(z),
                 torch.arange(M, device=device) < n_valid)


def detect_planes(cfg: SlamConfig, s: Scene, consolidate: bool = False):
    """The detect kernel's inputs for the scene: planes [P, 6 or 13, K]
    and z4 [M, 4], as the PHD update builds them."""
    pose_b = s.pose[:, None, :]
    cls = measurement.classify_in_range(pose_b, s.mean, s.weight, cfg)
    in_m = cls == measurement.IN_RANGE
    pre = ekf.ekf_preupdate(pose_b, s.mean, s.cov, cfg)
    planes = _detection_planes(in_m, pre, s.weight, consolidate, s.cov,
                               cfg.min_feature_weight)
    z4 = torch.stack([s.z[:, 0], s.z[:, 1], s.z_mask.to(s.z.dtype),
                      torch.zeros_like(s.z[:, 0])], dim=1)
    return planes.contiguous(), z4


def tables_payload(cfg: SlamConfig, s: Scene):
    """The PHD update's deferred-gather dict for the scene (through the
    detect kernel and the top-cap sort) and the fused merge's inputs:
    (gather, ints [P, 4, cap] int32, flts [P, 2, cap])."""
    g = _update_pre(*s, cfg)["gather"]
    return (g,) + tables_operands(g)
