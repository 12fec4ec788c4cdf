"""Synthetic ground truth and noisy scans (a copy of the parts of
``phdslam_tpu/eval/simdata.py`` that the port's evaluations use: for the
Monte-Carlo batch ``AckermanParams``, ``ackerman_motion``,
``generate_world``, ``generate_run`` and ``write_run_dir``; for the mixed
world ``wrap_angle``, ``SensorParams``, ``true_measurements``,
``noisy_measurements`` and ``generate_world_cv``; for the monocular camera
world ``camera_rotation_np``, ``generate_disparity_world`` and
``write_disparity_run_dir``).

The port keeps its own copy because ``phdslam_tpu/__init__.py`` imports jax;
``tests/test_torch_mixed.py``, ``tests/test_torch_disparity.py`` and
``tests/test_torch_batch.py`` hold it equal to the original from the same
seed. Pure numpy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

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


@dataclasses.dataclass
class AckermanParams:
    std_encoder: float = 2.0
    std_alpha: float = 0.0873
    l: float = 2.83
    h: float = 0.76
    a: float = 3.78
    b: float = 0.50


def ackerman_motion(pose, v_encoder, alpha, p: AckermanParams, dt):
    """One noiseless Ackerman step of (x, y, heading) (the filter's
    ``models/vehicle.py::ackerman_predict`` in numpy)."""
    x, y, th = pose
    vc = v_encoder / (1.0 - np.tan(alpha) * p.h / p.l)
    xc_dot = vc * np.cos(th)
    yc_dot = vc * np.sin(th)
    thc_dot = vc * np.tan(alpha) / p.l
    x2 = x + dt * (xc_dot - thc_dot * (p.a * np.sin(th) + p.b * np.cos(th)))
    y2 = y + dt * (yc_dot + thc_dot * (p.a * np.cos(th) - p.b * np.sin(th)))
    th2 = float(wrap_angle(th + dt * thc_dot))
    return np.array([x2, y2, th2])


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


def generate_world(n_landmarks=80, extent=20.0, n_steps=300, dt=0.1,
                   seed=0, mp: Optional[AckermanParams] = None,
                   control_profile="loop"):
    """Random landmark map and a driven Ackerman trajectory: speed 3 m/s,
    steering 0.15 sin over two periods ("loop"; straight otherwise).

    Returns (landmarks [L,2], trajectory [T,3], controls [T-1,2]).
    """
    rng = np.random.default_rng(seed)
    mp = mp or AckermanParams()
    landmarks = rng.uniform(-extent, extent, size=(n_landmarks, 2))

    controls = np.zeros((n_steps - 1, 2))
    if control_profile == "loop":
        controls[:, 0] = 3.0                       # constant speed
        controls[:, 1] = 0.15 * np.sin(
            np.linspace(0, 4 * np.pi, n_steps - 1))  # weaving steer
    else:
        controls[:, 0] = 3.0

    traj = np.zeros((n_steps, 3))
    for t in range(1, n_steps):
        traj[t] = ackerman_motion(traj[t - 1], controls[t - 1, 0],
                                  controls[t - 1, 1], mp, dt)
    return landmarks, traj, controls


def generate_run(landmarks, traj, controls, sp: SensorParams,
                 mp: AckermanParams, seed: int):
    """One Monte-Carlo input set: noisy controls + measurements."""
    rng = np.random.default_rng(seed)
    noisy_controls = controls + np.column_stack([
        rng.normal(0, mp.std_encoder, len(controls)),
        rng.normal(0, mp.std_alpha, len(controls))])
    noisy_controls[:, 1] = wrap_angle(noisy_controls[:, 1])
    measurements = [noisy_measurements(traj[t], landmarks, sp, rng)
                    for t in range(len(traj))]
    return noisy_controls.astype(np.float32), measurements


def write_run_dir(outdir, controls, measurements):
    """controls.txt and measurements.txt in the reference's text format."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "controls.txt"), "w") as fh:
        fh.write("% velocity\tsteering angle\n")
        for u in controls:
            fh.write("%g %g\n" % (u[0], u[1]))
    with open(os.path.join(outdir, "measurements.txt"), "w") as fh:
        fh.write("% measurements from simulation data. One time step per "
                 "line, each pair of of numbers is a range/bearing "
                 "measurement.\n")
        for Z in measurements:
            fh.write(" ".join("%g %g" % (z[0], z[1]) for z in Z) + " \n")


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


def camera_rotation_np(roll, pitch, yaw):
    """R such that world = R @ camera (``filters/disparity.py``'s
    ``camera_rotation`` in numpy)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([
        [cp * cy, cr * sy + sr * sp * cy, sr * sy - cr * sp * cy],
        [-cp * sy, cr * cy - sr * sp * sy, sr * cy + cr * sp * sy],
        [sp, -sr * cp, cr * cp]])


def generate_disparity_world(n_landmarks=30, n_steps=60, dt=0.5, seed=0,
                             fx=500.0, fy=500.0, u0=320.0, v0=240.0,
                             width=640, height=480, std_uv=1.0, pd=0.95,
                             clutter_rate=2.0, vx=0.1):
    """Camera translating along +x viewing landmarks at negative z:
    landmarks x U(-2, 4), y U(-1.5, 1.5), z U(-8, -3); detections with
    probability pd and N(0, std_uv) pixel noise inside the image, plus
    Poisson(clutter_rate) uniform clutter.

    Returns (landmarks [L, 3], cam_traj [T, 12], measurement sets).
    """
    rng = np.random.default_rng(seed)
    landmarks = np.column_stack([
        rng.uniform(-2, 4, n_landmarks),
        rng.uniform(-1.5, 1.5, n_landmarks),
        rng.uniform(-8, -3, n_landmarks)])
    traj = np.zeros((n_steps, 12))
    traj[:, 6] = vx
    for t in range(1, n_steps):
        traj[t, :3] = traj[t - 1, :3] + dt * traj[t - 1, 6:9]
    measurements = []
    for t in range(n_steps):
        R = camera_rotation_np(*traj[t, 3:6])
        pc = (landmarks - traj[t, :3]) @ R          # R^T (p - t)
        zc = pc[:, 2]
        vis = zc < -0.5
        u = u0 - fx * pc[:, 0] / zc
        v = v0 - fy * pc[:, 1] / zc
        uv = np.column_stack([u, v])[vis]
        uv = uv + rng.normal(0, std_uv, uv.shape)
        inside = ((uv[:, 0] > 0) & (uv[:, 0] < width)
                  & (uv[:, 1] > 0) & (uv[:, 1] < height))
        uv = uv[inside & (rng.random(len(uv)) < pd)]
        n_cl = rng.poisson(clutter_rate)
        clutter = np.column_stack([rng.uniform(0, width, n_cl),
                                   rng.uniform(0, height, n_cl)])
        measurements.append(np.vstack([uv, clutter]).astype(np.float32))
    return landmarks, traj, measurements


def write_disparity_run_dir(outdir, measurements):
    """measurements.txt in the imageMeasurementSet format (u v pairs)."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "measurements.txt"), "w") as fh:
        fh.write("% image measurements, one time step per line, u v pairs\n")
        for Z in measurements:
            fh.write(" ".join("%g %g" % (u, v) for u, v in Z) + " \n")
