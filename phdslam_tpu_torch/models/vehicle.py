"""Vehicle motion: constant velocity and Ackerman steering (port of
``phdslam_tpu/models/vehicle.py``).

Pose layout: ``pose[..., 6] = (px, py, ptheta, vx, vy, vtheta)``. The
standard-normal draw is an argument, so a test can feed the port the same
numbers the JAX version drew from its key.
"""

from __future__ import annotations

import torch

from ..ops.math import wrap_angle


def cv_predict(pose, noise_std, dt, eps):
    """Constant-velocity prediction with body-frame acceleration noise.

    pose [P, 6]; noise_std = (std_ax, std_ay, std_atheta), already scaled
    by the caller (the filter uses 3x the configured accelerations);
    eps [P, 3] standard normal.
    """
    ax = eps[:, 0] * noise_std[0]
    ay = eps[:, 1] * noise_std[1]
    ath = eps[:, 2] * noise_std[2]

    px, py, th = pose[:, 0], pose[:, 1], pose[:, 2]
    vx, vy, vth = pose[:, 3], pose[:, 4], pose[:, 5]
    c, s = torch.cos(th), torch.sin(th)

    px_new = px + dt * (vx * c - vy * s) + 0.5 * dt * dt * (ax * c - ay * s)
    py_new = py + dt * (vx * s + vy * c) + 0.5 * dt * dt * (ax * s + ay * c)
    th_new = wrap_angle(th + dt * vth + 0.5 * dt * dt * ath)
    return torch.stack([px_new, py_new, th_new, vx + dt * ax, vy + dt * ay,
                        vth + dt * ath], dim=-1)


def ackerman_predict(pose, control, geom, noise_std, dt, eps):
    """Ackerman-steering prediction.

    pose [P, 6]; control = (v_encoder, alpha); geom = (l, h, a, b);
    noise_std = (std_encoder, std_alpha); eps [P, 2] standard normal.
    The velocity state components are zeroed, as in the JAX version.
    """
    ve = control[0] + eps[:, 0] * noise_std[0]
    alpha = control[1] + eps[:, 1] * noise_std[1]

    l, h, a, b = geom
    px, py, th = pose[:, 0], pose[:, 1], pose[:, 2]

    tan_a = torch.tan(alpha)
    vc = ve / (1.0 - tan_a * h / l)
    xc_dot = vc * torch.cos(th)
    yc_dot = vc * torch.sin(th)
    thc_dot = vc * tan_a / l

    s, c = torch.sin(th), torch.cos(th)
    px_new = px + dt * (xc_dot - thc_dot * (a * s + b * c))
    py_new = py + dt * (yc_dot + thc_dot * (a * c - b * s))
    th_new = wrap_angle(th + dt * thc_dot)
    zeros = torch.zeros_like(px)
    return torch.stack([px_new, py_new, th_new, zeros, zeros, zeros], dim=-1)
