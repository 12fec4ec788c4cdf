"""Filter state as dataclasses of tensors (port of ``phdslam_tpu/types.py``).

Fixed-capacity structure-of-arrays: the map of every particle is
[P, K, D] means, [P, K, D, D] covariances and [P, K] linear weights; a slot
with weight 0 is empty and holds mean 0 and identity covariance. The 4D
dynamic map exists only for the mixed model (feature_model 2) and the
log cardinality distribution only for the CPHD filter (filter_type 1);
each is None otherwise, so the static PHD path gathers nothing extra. The
per-particle MC map variance (compute_variance) is zeros until an update
estimates it. The two-scan birth memory (``prev_z``) exists only for the
mixed model with birth_velocity_init, as in the JAX state. The
random stream lives in the runner's ``torch.Generator``, not
in the state. :class:`DisparityState` is the monocular SC-PHD (disparity)
filter's particle set: camera poses and per-feature clouds of world
points.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch


@dataclasses.dataclass
class GMState:
    """Per-particle fixed-capacity Gaussian mixture.

    mean:   [P, K, D]
    cov:    [P, K, D, D]  (empty slots hold identity)
    weight: [P, K] linear weights; 0 marks an empty slot
    """
    mean: torch.Tensor
    cov: torch.Tensor
    weight: torch.Tensor

    @staticmethod
    def empty(n_particles: int, capacity: int, dim: int, device,
              dtype=torch.float32) -> "GMState":
        eye = torch.eye(dim, dtype=dtype, device=device)
        return GMState(
            mean=torch.zeros((n_particles, capacity, dim), dtype=dtype,
                             device=device),
            cov=eye.expand(n_particles, capacity, dim, dim).clone(),
            weight=torch.zeros((n_particles, capacity), dtype=dtype,
                               device=device))


@dataclasses.dataclass
class FilterState:
    """Particle set of the Rao-Blackwellized PHD-SLAM filter.

    pose:         [P, 6] (px, py, ptheta, vx, vy, vtheta)
    log_weight:   [P] log particle weights
    map_static:   2D GM map per particle
    resample_idx: [P] ancestor indices of the last step
    step:         steps taken so far
    map_dynamic:  4D (x, y, vx, vy) GM map per particle, feature_model 1
                  (the dynamic-only map) or 2 (None otherwise)
    cardinality:  [P, C+1] log cardinality distribution per particle,
                  filter_type 1 (CPHD) only (None otherwise)
    variance:     [P] MC map-variance estimates (compute_variance; zeros
                  otherwise)
    prev_z:       [P, max_measurements, 3] the previous scan's measurement
                  positions in world coordinates per particle (x, y,
                  valid), for the mixed model's two-scan velocity births
                  (birth_velocity_init; None otherwise)
    """
    pose: torch.Tensor
    log_weight: torch.Tensor
    map_static: GMState
    resample_idx: torch.Tensor
    step: int = 0
    map_dynamic: Optional[GMState] = None
    cardinality: Optional[torch.Tensor] = None
    variance: Optional[torch.Tensor] = None
    prev_z: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "FilterState":
        return dataclasses.replace(self, **changes)


def init_state(cfg, n_particles: Optional[int] = None, device="cpu",
               dtype=torch.float32) -> FilterState:
    """All particles at the configured prior pose with empty maps (the
    [P, K, 4] dynamic map only for feature_model 1 and 2), for the CPHD
    filter a uniform cardinality over 0..max_cardinality and, for the
    mixed model with birth_velocity_init, an empty previous scan."""
    P = n_particles if n_particles is not None else cfg.n_particles
    K = cfg.max_components
    pose0 = torch.tensor(
        [cfg.x0, cfg.y0, cfg.yaw0, cfg.vx0, cfg.vy0, cfg.vyaw0], dtype=dtype,
        device=device)
    log_p = torch.log(torch.tensor(float(P), dtype=dtype, device=device))
    cardinality = None
    if cfg.filter_type == 1:
        C1 = cfg.max_cardinality + 1
        log_c = torch.log(torch.tensor(float(C1), dtype=dtype, device=device))
        cardinality = (-log_c).expand(P, C1).clone()
    return FilterState(
        pose=pose0.expand(P, 6).clone(),
        log_weight=(-log_p).expand(P).clone(),
        map_static=GMState.empty(P, K, 2, device, dtype),
        resample_idx=torch.arange(P, dtype=torch.int32, device=device),
        step=0,
        map_dynamic=(GMState.empty(P, K, 4, device, dtype)
                     if cfg.feature_model in (1, 2) else None),
        cardinality=cardinality,
        variance=torch.zeros((P,), dtype=dtype, device=device),
        prev_z=(torch.zeros((P, cfg.max_measurements, 3), dtype=dtype,
                            device=device)
                if cfg.feature_model == 2 and cfg.birth_velocity_init
                else None))


def state_from_jax(arrays: Mapping[str, np.ndarray], device="cpu"
                   ) -> FilterState:
    """Build a state from numpy copies of a ``phdslam_tpu`` FilterState.

    ``arrays`` holds "pose", "log_weight", "map_mean", "map_cov",
    "map_weight", "resample_idx" and "step" (the JAX state's ``pose``,
    ``log_weight``, ``map_static.*``, ``resample_idx`` and ``step``) — the
    keys :func:`state_to_numpy` writes — and, for a state with a dynamic
    map, "dyn_mean", "dyn_cov" and "dyn_weight" (``map_dynamic.*``), for a
    CPHD state "cardinality"; "variance" (the JAX state's ``variance``)
    when given, else zeros; "prev_z" (the JAX state's ``prev_z``) for a
    state that carries the two-scan birth memory.
    """
    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype,
                            device=device)
    dyn = None
    if "dyn_mean" in arrays:
        dyn = GMState(mean=t("dyn_mean", torch.float32),
                      cov=t("dyn_cov", torch.float32),
                      weight=t("dyn_weight", torch.float32))
    return FilterState(
        pose=t("pose", torch.float32),
        log_weight=t("log_weight", torch.float32),
        map_static=GMState(mean=t("map_mean", torch.float32),
                           cov=t("map_cov", torch.float32),
                           weight=t("map_weight", torch.float32)),
        resample_idx=t("resample_idx", torch.int32),
        step=int(np.asarray(arrays["step"])),
        map_dynamic=dyn,
        cardinality=(t("cardinality", torch.float32)
                     if "cardinality" in arrays else None),
        variance=(t("variance", torch.float32) if "variance" in arrays
                  else torch.zeros(np.asarray(arrays["log_weight"]).shape,
                                   dtype=torch.float32, device=device)),
        prev_z=t("prev_z", torch.float32) if "prev_z" in arrays else None)


def state_to_numpy(state: FilterState) -> dict:
    """Numpy copies of a state, keyed as :func:`state_from_jax` reads them."""
    gm = state.map_static
    out = {"pose": state.pose, "log_weight": state.log_weight,
           "map_mean": gm.mean, "map_cov": gm.cov, "map_weight": gm.weight,
           "resample_idx": state.resample_idx}
    if state.variance is not None:
        out["variance"] = state.variance
    if state.map_dynamic is not None:
        dyn = state.map_dynamic
        out.update(dyn_mean=dyn.mean, dyn_cov=dyn.cov, dyn_weight=dyn.weight)
    if state.cardinality is not None:
        out["cardinality"] = state.cardinality
    if state.prev_z is not None:
        out["prev_z"] = state.prev_z
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    out["step"] = np.asarray(state.step, np.int32)
    return out


@dataclasses.dataclass
class DisparityState:
    """Particle set of the monocular SC-PHD (disparity) filter, fixed
    capacity.

    cam_pose:     [P, 12] (px, py, pz, roll, pitch, yaw, vx, vy, vz, vroll,
                  vpitch, vyaw)
    log_weight:   [P] log particle weights
    cloud:        [P, K, N, 3] per-feature clouds of world points
    feat_weight:  [P, K] linear feature weights (0 = empty slot)
    resample_idx: [P] ancestor indices of the last step
    step:         steps taken so far
    """
    cam_pose: torch.Tensor
    log_weight: torch.Tensor
    cloud: torch.Tensor
    feat_weight: torch.Tensor
    resample_idx: torch.Tensor
    step: int = 0

    def replace(self, **changes) -> "DisparityState":
        return dataclasses.replace(self, **changes)


_DISPARITY_KEYS = ("cam_pose", "log_weight", "cloud", "feat_weight",
                   "resample_idx")


def disparity_state_from_jax(arrays: Mapping[str, np.ndarray], device="cpu"
                             ) -> DisparityState:
    """Build a disparity state from numpy copies of a ``phdslam_tpu``
    DisparityState: "cam_pose", "log_weight", "cloud", "feat_weight",
    "resample_idx" and "step" (the JAX state's fields of those names, the
    keys :func:`disparity_state_to_numpy` writes). The JAX state's ``rng``
    has no counterpart: the runner's generator draws the noise."""
    fields = {k: torch.tensor(np.asarray(arrays[k]), device=device,
                              dtype=torch.int32 if k == "resample_idx"
                              else torch.float32)
              for k in _DISPARITY_KEYS}
    return DisparityState(**fields, step=int(np.asarray(arrays["step"])))


def disparity_state_to_numpy(state: DisparityState) -> dict:
    """Numpy copies of a disparity state, keyed as
    :func:`disparity_state_from_jax` reads them."""
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in _DISPARITY_KEYS}
    out["step"] = np.asarray(state.step, np.int32)
    return out
