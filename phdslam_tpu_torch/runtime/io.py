"""Dataset loaders, the state-log writer and the particle dumps (port of
``phdslam_tpu/runtime/io.py``).

The port keeps its own copies because importing ``phdslam_tpu`` imports jax.
The loaders are the originals' pure-Python paths (they run once per
dataset). :func:`write_state_log`, which runs every step, is the port's
own C++ writer (``runtime/native/textio.cpp``), as the JAX package runs
its own; the pure-Python writer stays as its plain version
(:func:`write_state_log_reference`), which the tests hold it to byte for
byte. ``tests/test_torch_ops.py`` and ``tests/test_torch_native.py`` hold
the loaders equal to the originals on the shipped datasets,
``tests/test_torch_runtime.py`` and ``tests/test_torch_native.py`` the
writers.

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

from . import native


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


def load_trajectory(path: str) -> np.ndarray:
    """[N, 6] CV states; '%'-prefixed header lines skipped."""
    rows = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("%") or not line.strip():
                continue
            vals = np.fromstring(line, sep=" ")
            if len(vals) >= 6:
                rows.append(vals[:6])
    return np.asarray(rows, dtype=np.float32)


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


def write_state_log(outdir: str, t: int, expected_pose, static_map,
                    dynamic_map, particle_log_weights, particle_poses,
                    resample_idx, cardinality, max_cardinality: int,
                    filter_type: int = 0):
    """Append step t's ``state_estimateXXXXX.log`` (the reference's 6-line
    text format, ``%g`` numbers, each line ending in a space):
    the expected pose; the static map and the dynamic map, each as
    (w, mean, flattened cov) of every component with w > 0; the particle
    log weights; the particle poses; the resampling ancestors; and the
    MAP particle's log cardinality (CPHD) or max_cardinality + 1 zeros.
    The C++ writer; the bytes of :func:`write_state_log_reference`.

    static_map / dynamic_map: (weights[K], means[K,D], covs[K,D,D]) or
    None.
    """
    lines = [(native.LINE_G, expected_pose)]
    for gm, D in ((static_map, 2), (dynamic_map, 4)):
        row = np.zeros(0)
        if gm is not None:
            w, m, c = (np.asarray(x) for x in gm)
            live = w > 0
            row = np.concatenate([w[live, None], m[live, :D],
                                  c[live, :D, :D].reshape(-1, D * D)],
                                 axis=1)
        lines.append((native.LINE_MAP, row))
    lines += [(native.LINE_G, particle_log_weights),
              (native.LINE_G, particle_poses),
              (native.LINE_INT, resample_idx)]
    if filter_type == 1 and cardinality is not None:
        lines.append((native.LINE_G,
                      np.asarray(cardinality)[: max_cardinality + 1]))
    else:
        lines.append((native.LINE_INT, np.zeros(max_cardinality + 1)))
    native.write_lines(os.path.join(outdir, "state_estimate%05d.log" % t),
                       lines)


def write_state_log_reference(outdir: str, t: int, expected_pose,
                              static_map, dynamic_map, particle_log_weights,
                              particle_poses, resample_idx, cardinality,
                              max_cardinality: int, filter_type: int = 0):
    """Plain Python version of :func:`write_state_log`."""
    path = os.path.join(outdir, "state_estimate%05d.log" % t)
    with open(path, "a") as fh:
        fh.write(" ".join("%g" % v for v in np.asarray(expected_pose))
                 + " \n")
        for gm, D in ((static_map, 2), (dynamic_map, 4)):
            if gm is not None:
                w, m, c = (np.asarray(x) for x in gm)
                parts = []
                for i in range(len(w)):
                    if not w[i] > 0:    # NaN too, as the C++ writer
                        continue
                    parts.append("%g" % w[i])
                    parts.extend("%g" % v for v in m[i, :D])
                    parts.extend("%g" % v for v in c[i, :D, :D].reshape(-1))
                if parts:
                    fh.write(" ".join(parts) + " ")
            fh.write("\n")
        fh.write(" ".join("%g" % v for v in np.asarray(particle_log_weights))
                 + " \n")
        poses = np.asarray(particle_poses)
        fh.write(" ".join("%g" % v for v in poses.reshape(-1)) + " \n")
        fh.write(" ".join("%d" % v for v in np.asarray(resample_idx)) + " \n")
        if filter_type == 1 and cardinality is not None:
            fh.write(" ".join("%g" % v for v in np.asarray(cardinality)
                              [: max_cardinality + 1]) + " \n")
        else:
            fh.write(" ".join(["0"] * (max_cardinality + 1)) + " \n")


def _numpy(x):
    return x.detach().cpu().numpy()


def write_particles_mat(path: str, state, cfg, map_estimate=None,
                        variances=None):
    """Full particle dump as a .mat file, with the JAX version's keys and
    shapes: particle poses, weights, ancestors, the per-particle static
    and dynamic maps (an empty [P, K, 4] dynamic map where the state has
    none, as the JAX state always holds one), the variance estimates
    (zeros where the state has none), the cardinalities (CPHD) and the
    extracted map estimate (w, m, c) when given."""
    import scipy.io as sio
    P, K = state.map_static.weight.shape
    dyn = state.map_dynamic
    if dyn is None:
        dyn_mean = np.zeros((P, K, 4), np.float32)
        dyn_cov = np.broadcast_to(np.eye(4, dtype=np.float32),
                                  (P, K, 4, 4)).copy()
        dyn_weight = np.zeros((P, K), np.float32)
    else:
        dyn_mean, dyn_cov, dyn_weight = (_numpy(dyn.mean), _numpy(dyn.cov),
                                         _numpy(dyn.weight))
    if variances is None:
        variances = (np.zeros((P,), np.float32) if state.variance is None
                     else _numpy(state.variance))
    data = {
        "weights": state.log_weight.cpu().numpy(),
        "particles": _numpy(state.pose),
        "resample_idx": state.resample_idx.cpu().numpy(),
        "maps_mean": _numpy(state.map_static.mean),
        "maps_cov": _numpy(state.map_static.cov),
        "maps_weight": _numpy(state.map_static.weight),
        "maps_dynamic_mean": dyn_mean,
        "maps_dynamic_cov": dyn_cov,
        "maps_dynamic_weight": dyn_weight,
        "vars": np.asarray(variances),
    }
    if state.cardinality is not None:
        data["cardinalities"] = _numpy(state.cardinality)
    if map_estimate is not None:
        w, m, c = (x if isinstance(x, np.ndarray) else _numpy(x)
                   for x in map_estimate)
        data["map_estimate_weight"] = w
        data["map_estimate_mean"] = m
        data["map_estimate_cov"] = c
    sio.savemat(path, data)


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
