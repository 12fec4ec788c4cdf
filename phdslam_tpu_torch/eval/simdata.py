"""Synthetic ground truth and noisy range-bearing scans (a copy of the parts
of ``phdslam_tpu/eval/simdata.py`` that the mixed-world evaluation uses:
``wrap_angle``, ``SensorParams``, ``true_measurements``,
``noisy_measurements`` and ``generate_world_cv``).

The port keeps its own copy because ``phdslam_tpu/__init__.py`` imports jax;
``tests/test_torch_mixed.py`` holds it equal to the original from the same
seed. Pure numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def wrap_angle(a):
    r = np.remainder(a, 2 * np.pi)
    r = np.where(r > np.pi, r - 2 * np.pi, r)
    r = np.where(r < -np.pi, r + 2 * np.pi, r)
    return r


@dataclasses.dataclass
class SensorParams:
    max_range: float = 10.0
    max_bearing: float = np.pi
    std_range: float = 1.0
    std_bearing: float = 0.0349
    pd: float = 0.95
    clutter_rate: float = 20.0


def true_measurements(pose, landmarks, sp: SensorParams):
    """Range and bearing of every landmark inside the sensor's range and
    field of view."""
    dx = landmarks[:, 0] - pose[0]
    dy = landmarks[:, 1] - pose[1]
    r = np.hypot(dx, dy)
    b = wrap_angle(np.arctan2(dy, dx) - pose[2])
    keep = (r <= sp.max_range) & (np.abs(b) <= sp.max_bearing)
    return np.column_stack([r[keep], b[keep]])


def noisy_measurements(pose, landmarks, sp: SensorParams, rng):
    """Detections with probability pd plus Gaussian range/bearing noise,
    then Poisson(clutter_rate) uniform clutter."""
    z = true_measurements(pose, landmarks, sp)
    detected = rng.random(len(z)) < sp.pd
    z = z[detected]
    z = z + np.column_stack([rng.normal(0, sp.std_range, len(z)),
                             rng.normal(0, sp.std_bearing, len(z))])
    z[:, 1] = wrap_angle(z[:, 1])
    n_clutter = rng.poisson(sp.clutter_rate)
    clutter = np.column_stack([
        rng.random(n_clutter) * sp.max_range,
        rng.random(n_clutter) * 2 * sp.max_bearing - sp.max_bearing])
    return np.vstack([z, clutter]).astype(np.float32)


def generate_world_cv(n_landmarks=40, extent=20.0, n_steps=150, dt=0.1,
                      seed=0, v0=3.0, yaw_rate=0.15,
                      std_acc=(0.3, 0.0, 0.03)):
    """Constant-velocity-vehicle ground truth: random landmarks and a
    body-frame CV trajectory with small random accelerations (the model of
    ``models/vehicle.py::cv_predict``).

    Returns (landmarks [L, 2], trajectory [T, 3] = x, y, yaw).
    """
    rng = np.random.default_rng(seed)
    landmarks = rng.uniform(-extent, extent, size=(n_landmarks, 2))
    st = np.array([0.0, 0.0, 0.0, v0, 0.0, yaw_rate])  # x y th vx vy vth
    traj = np.zeros((n_steps, 3))
    for t in range(n_steps):
        traj[t] = st[:3]
        ax, ay, ath = rng.normal(0.0, std_acc)
        c, s = np.cos(st[2]), np.sin(st[2])
        st[0] += dt * (st[3] * c - st[4] * s) + 0.5 * dt * dt * (ax * c - ay * s)
        st[1] += dt * (st[3] * s + st[4] * c) + 0.5 * dt * dt * (ax * s + ay * c)
        st[2] = wrap_angle(st[2] + dt * st[5] + 0.5 * dt * dt * ath)
        st[3:] += dt * np.array([ax, ay, ath])
    return landmarks, traj
