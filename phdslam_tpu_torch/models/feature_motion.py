"""Feature (landmark / target) motion models (port of
``phdslam_tpu/models/feature_motion.py``: the constant-velocity model with
per-feature noise scaling and the jump-Markov mixed prediction).

All functions work on batched ``mean[..., D]`` / ``cov[..., D, D]`` /
``weight[...]`` tensors.
"""

from __future__ import annotations

import torch

from ..ops.math import logistic


def constant_velocity_predict(mean, cov, std_ax, std_ay, dt, scale_x,
                              scale_y):
    """4D constant-velocity model (x, y, vx, vy) with white-acceleration
    noise: F = [[I, dt I], [0, I]], Q = [[dt^4/4 q, dt^3/2 q],
    [dt^3/2 q, dt^2 q]] with q = diag(std_ax^2 scale_x, std_ay^2 scale_y);
    ``scale_x`` / ``scale_y`` are per-feature tensors shaped like
    ``mean[..., 0]``."""
    var_x = (std_ax ** 2) * scale_x
    var_y = (std_ay ** 2) * scale_y
    d4 = (dt ** 4) / 4.0
    d3 = (dt ** 3) / 2.0
    d2 = dt ** 2
    Q = torch.zeros(var_x.shape + (4, 4), dtype=mean.dtype,
                    device=mean.device)
    Q[..., 0, 0] = d4 * var_x
    Q[..., 1, 1] = d4 * var_y
    Q[..., 0, 2] = Q[..., 2, 0] = d3 * var_x
    Q[..., 1, 3] = Q[..., 3, 1] = d3 * var_y
    Q[..., 2, 2] = d2 * var_x
    Q[..., 3, 3] = d2 * var_y
    F = torch.tensor([[1.0, 0.0, dt, 0.0],
                      [0.0, 1.0, 0.0, dt],
                      [0.0, 0.0, 1.0, 0.0],
                      [0.0, 0.0, 0.0, 1.0]], dtype=mean.dtype,
                     device=mean.device)
    mean_new = torch.einsum("ij,...j->...i", F, mean)
    cov_new = torch.einsum("ij,...jk,lk->...il", F, cov, F) + Q
    return mean_new, cov_new


def mixed_model_predict(mean, cov, weight, cfg, dt):
    """Jump-Markov prediction of the 4D dynamic map.

    Mixed model (feature_model 2): the probability of staying dynamic is
    the speed sigmoid p_jmm = 1 / (1 + exp(beta (tau - |v|))), survival
    is cfg.ps, and the CV model runs unscaled. Dynamic-only model
    (feature_model 1): p_jmm = 1, survival 1 - logistic(|v|, 0, 1 - ps,
    beta, tau), and the CV process noise scaled per axis by
    logistic(v_x), logistic(v_y) (0 to 1).

    Returns the predicted dynamic map (weights p_jmm ps w) and the 2D jump
    copies (weights (1 - p_jmm) w), which the filter computes and drops
    (the reference leaves their static-map injection disabled).
    """
    vx = mean[..., 2]
    vy = mean[..., 3]
    v_mag = torch.sqrt(vx * vx + vy * vy)
    if cfg.feature_model == 1:
        p_jmm = torch.ones_like(v_mag)
        ps = 1.0 - logistic(v_mag, 0.0, 1.0 - cfg.ps, cfg.beta, cfg.tau)
        scale_x = logistic(vx, 0.0, 1.0, cfg.beta, cfg.tau)
        scale_y = logistic(vy, 0.0, 1.0, cfg.beta, cfg.tau)
    else:
        p_jmm = 1.0 / (1.0 + torch.exp(cfg.beta * (cfg.tau - v_mag)))
        ps = torch.full_like(v_mag, cfg.ps)
        scale_x = scale_y = torch.ones_like(v_mag)
    mean_new, cov_new = constant_velocity_predict(
        mean, cov, cfg.std_ax_map, cfg.std_ay_map, dt, scale_x, scale_y)
    weight_new = p_jmm * ps * weight
    jump = (mean[..., :2], cov[..., :2, :2], (1.0 - p_jmm) * weight)
    return (mean_new, cov_new, weight_new), jump
