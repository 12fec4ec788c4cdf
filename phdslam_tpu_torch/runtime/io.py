"""Dataset loaders (copies of ``phdslam_tpu/runtime/io.py``'s numpy loaders)
and the disparity filter's particle dump.

The port keeps its own copies because importing ``phdslam_tpu`` imports jax.
These are the portable pure-Python paths of the originals (the JAX package
prefers its C++ text parser when built); ``tests/test_torch_ops.py`` holds
them equal to the originals on the shipped datasets.

Format notes:
* measurements files: one time step per line, header line first; each
  measurement is a (range, bearing) pair, or (range, bearing, label) when
  ``labeled == True``.
* controls files: header line then ``v_encoder alpha`` per line.
* timestamps: one float per line.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def load_measurements(path: str, labeled: bool = False) -> List[np.ndarray]:
    """Load per-step measurement sets. Returns a list of [n_i, 2] arrays
    (range, bearing) (+labels column when labeled)."""
    out: List[np.ndarray] = []
    width = 3 if labeled else 2
    with open(path) as fh:
        first = True
        for line in fh:
            if first:  # header line
                first = False
                continue
            vals = np.fromstring(line, sep=" ") if line.strip() else np.empty(0)
            n = (len(vals) // width) * width
            out.append(vals[:n].reshape(-1, width).astype(np.float32))
    # drop the trailing empty entry produced by a final blank line
    if out and out[-1].size == 0:
        out.pop()
    return out


def load_controls(path: str) -> np.ndarray:
    """Load (v_encoder, alpha) controls; [N, 2]."""
    rows = []
    with open(path) as fh:
        first = True
        for line in fh:
            if first:
                first = False
                continue
            line = line.replace(",", " ")
            vals = np.fromstring(line, sep=" ")
            if len(vals) >= 2:
                rows.append(vals[:2])
    return np.asarray(rows, dtype=np.float32) if rows else np.zeros((0, 2),
                                                                    np.float32)


def load_timestamps(path: str) -> np.ndarray:
    """One float per line; a missing file gives an empty array."""
    if not os.path.exists(path):
        return np.zeros((0,), np.float32)
    vals = []
    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if s:
                vals.append(float(s.split()[0]))
    return np.asarray(vals, dtype=np.float32)


def pad_measurements(measurements: List[np.ndarray], m_max: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack ragged per-step measurements into fixed [T, M_max, 2] + mask.

    Steps with more than m_max measurements are truncated.
    """
    T = len(measurements)
    z = np.zeros((T, m_max, 2), dtype=np.float32)
    mask = np.zeros((T, m_max), dtype=bool)
    for t, zt in enumerate(measurements):
        n = min(len(zt), m_max)
        if n > 0:
            z[t, :n] = zt[:n, :2]
            mask[t, :n] = True
    return z, mask


def write_disparity_particles_mat(path: str, state):
    """Full disparity-particle dump as a .mat file (the reference's per-step
    debug dump of the disparity loop): camera poses, log weights, ancestor
    indices, per-feature particle clouds and feature weights."""
    import scipy.io as sio
    sio.savemat(path, {
        "weights": state.log_weight.cpu().numpy(),
        "particles": state.cam_pose.cpu().numpy(),
        "resample_idx": state.resample_idx.cpu().numpy(),
        "clouds": state.cloud.cpu().numpy(),
        "feature_weights": state.feat_weight.cpu().numpy(),
    })
