"""Times the port's detect kernels at every shape the paths launch.

    python3 detect_bench.py [--root DIR] [--label NAME] [--out FILE]
                            [--expect FILE]

Needs one NVIDIA GPU; imports no jax. ``phdslam_tpu_torch`` is imported
from DIR (default: the directory of this script), so that two checkouts can
be held side by side on one card in one call, as with ``gather_bench.py``:
unpack the other into a directory that ``.gitignore`` lists and run parent,
change, change, parent.

The cases (``DETECT_TIMED``) are each detect variant at the shapes the
paths launch it, on ``eval/scenes.py``'s scenes, and on the exact inputs of
step 60 of a real run (``CAPTURED``: the dense configuration at P=1024 plain,
fused + adaptive and consolidating + adaptive, and the Ackerman one at
P=512), and of step 20 of the dense runs at max_features 2048, plain and
consolidating + adaptive. For each it checks the kernel against its twin
(:func:`compare_detect`, the gates of PERF.md §2) and prints one JSON line:
the time per eager call, host included (``call_ms``: what a caller of the
wrapper waits), the device time of calls replayed from a CUDA graph
(``graph_ms``), the bound, the distribution of live counts over the rows
with a valid measurement, and a digest of every output (``out_sha``) and of
the inputs. The edge cases (``DETECT_EDGES``) follow, each in the narrow
and the wide variant, checked and digested the same way, untimed. ``--out FILE`` keeps the lines; ``--expect FILE``
requires every case's output digest to equal the one in FILE (another
checkout's run on the same inputs): the two kernels then agree bit for bit.

This module is also the one home of the detect kernels' edge cases
(``DETECT_EDGES``, :func:`detect_edge_case`), of the step capture
(``CAPTURED``, :func:`capture_step`; its "full grid", "mixed" and
"disparity" runs capture only the merge, for ``merge_bench.py``), of the
mixed bench's configuration and scans (:func:`mixed_runner`) and of the
comparison with the twin;
``chip_smoke.py``, ``merge_bench.py`` and the tests import them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import sys
from unittest import mock

import numpy as np
import torch

from gather_bench import (HBM_BPS, bench_parser, graph_ms, open_checkout,
                          time_call)

F32_FLOPS = 67e12               # H100 SXM data sheet, f32 outside the
                                # tensor cores, at 700 W

# name: (P, K, M, valid measurements, T, options). Planes follow
# tests/test_pallas_detect.py::make_case; at min_fw 0 the inverse
# covariances are small, so every feature with pref > 0 is live in every
# valid row. Options: "live": n gives pref > 0 on exactly n features of
# each particle, at min_fw 0, so every valid row holds exactly n live
# lanes; "dup": features K/2.. repeat features 0.., every one live (ties at
# the T-th value);
# "nan": a NaN in one particle's si00 plane; "min_fw", "cb": the thresholds
# (default 1e-4 and 0.05, the unthresholded mode at 0 and 0)
DETECT_EDGES = {
    "count T": (4, 128, 8, 6, 32, {"live": 32}),
    "count T + 1": (4, 128, 8, 6, 32, {"live": 33}),
    "count T at T 16": (4, 128, 8, 6, 16, {"live": 16}),
    "count T + 1 at T 16": (4, 128, 8, 6, 16, {"live": 17}),
    "all dead": (3, 64, 8, 8, 16, {"live": 0}),
    "K 100": (4, 100, 8, 6, 16, {"min_fw": 0.0, "cb": 0.0}),
    "T = K": (3, 40, 8, 6, 40, {"live": 40}),
    "T 1": (4, 128, 8, 6, 1, {"min_fw": 0.0}),
    "M 1": (4, 128, 1, 1, 16, {"min_fw": 0.0}),
    "NaN plane": (4, 128, 8, 6, 16, {"nan": True, "min_fw": 0.0}),
    "duplicates T 32": (4, 128, 8, 6, 32, {"dup": True}),
    "K 1024 T 32": (2, 1024, 9, 8, 32, {"min_fw": 0.0}),
}
MIN_SEP_EDGES = 2.0             # the consolidating edge cases' min_sep


def detect_edge_case(name, cons=False, seed=0):
    """(planes [P, 6 or 13, K] f32, z4 [M, 4] f32, T, min_fw, cb) of
    DETECT_EDGES[name] as numpy; with ``cons`` the 7 consolidation planes
    (wp, q00 q01 q11, p00 p01 p11) follow the 6."""
    P, K, M, n_valid, T, opt = DETECT_EDGES[name]
    rng = np.random.default_rng(seed + K + 100 * M + T)
    r = rng.uniform(1, 10, (P, K))
    bearing = rng.uniform(-np.pi, np.pi, (P, K))
    si00 = rng.uniform(0.5, 4.0, (P, K))
    si01 = rng.uniform(-0.2, 0.2, (P, K))
    si11 = rng.uniform(0.5, 4.0, (P, K))
    pref = np.where(rng.uniform(size=(P, K)) < 0.7,
                    rng.uniform(0.01, 1.0, (P, K)), 0.0)
    min_fw, cb = opt.get("min_fw", 1e-4), opt.get("cb", 0.05)
    if "live" in opt or opt.get("dup"):
        min_fw = 0.0
        pref = rng.uniform(0.01, 1.0, (P, K))
    if min_fw == 0.0:
        # exp stays far above the subnormals (which XLA's CPU exp flushes
        # to zero and PyTorch's keeps): every feature with pref > 0 is live
        si00, si11, si01 = si00 * 0.01, si11 * 0.01, si01 * 0.01
    if "live" in opt:
        keep = np.argsort(rng.uniform(size=(P, K)), axis=1) < opt["live"]
        pref = np.where(keep, pref, 0.0)
    if opt.get("dup"):
        h = K // 2
        for x in (r, bearing, si00, si01, si11, pref):
            x[:, h:2 * h] = x[:, :h]
    planes = [r, bearing, si00, si01, si11, pref]
    if cons:
        wp = np.where(rng.uniform(size=(P, K)) < 0.5,
                      rng.uniform(0.01, 1.0, (P, K)), 0.0)
        quads = [rng.uniform(0.02, 0.5, (P, K)), rng.uniform(-0.01, 0.01,
                                                             (P, K)),
                 rng.uniform(0.02, 0.5, (P, K))]
        quads += [rng.uniform(0.02, 0.5, (P, K)), rng.uniform(-0.01, 0.01,
                                                              (P, K)),
                  rng.uniform(0.02, 0.5, (P, K))]
        planes += [wp] + quads
    planes = np.stack(planes, axis=1).astype(np.float32)
    if opt.get("nan"):
        planes[1, 2, 5] = np.nan
    z4 = np.stack([rng.uniform(1, 10, M), rng.uniform(-np.pi, np.pi, M),
                   (np.arange(M) < n_valid).astype(float), np.zeros(M)],
                  axis=1).astype(np.float32)
    return planes, z4, T, min_fw, cb


# ----------------------------------------------------------------------------
# kernel inputs captured from a real step
# ----------------------------------------------------------------------------

CAPTURE_STEP = 60
# the mixed bench with both candidate caps off: the per-particle route over
# the full grid, 128 + 32 * 128 + 32 = 4256 lanes a map
MIXED_FULL = {"mixed_fast_path": 0, "merge_candidate_cap": 0,
              "merge_candidate_cap_dynamic": 0}
DENSE = ("cfg/dense.cfg", "data/dense", 1024)
ACKERMAN = ("cfg/ackerman.cfg", "data/ackerman", 512)
FUSED_ADAPTIVE = {"fused_gather_merge": 1, "detect_adaptive": 1}
CONS_ADAPTIVE = {"premerge_consolidate": 1, "detect_adaptive": 1}
# run: (runner, config, data, P, overrides, the wrappers captured, step).
# runner "synth": SynthSLAMRunner over the config and dataset, wrappers of
# filters/phd.py; "mixed": the mixed bench's ScanRunner (:func:`mixed_runner`,
# no config file), filters/phd.py's wrappers; "disparity": DisparityRunner,
# filters/disparity.py's wrappers (its profile window starts at frame 20)
CAPTURED = {
    "dense": ("synth", *DENSE, {}, ("detect", "merge2d"), CAPTURE_STEP),
    "dense fused + adaptive": ("synth", *DENSE, FUSED_ADAPTIVE,
                               ("detect", "merge2d_tables"), CAPTURE_STEP),
    "dense consolidating + adaptive": ("synth", *DENSE, CONS_ADAPTIVE,
                                       ("detect",), CAPTURE_STEP),
    "ackerman": ("synth", *ACKERMAN, {}, ("detect", "merge2d"),
                 CAPTURE_STEP),
    # the uncapped route: every lane of the grid to merge2d's argmax mode
    "full grid": ("synth", *ACKERMAN, {"merge_candidate_cap": 0},
                  ("merge2d",), CAPTURE_STEP),
    # the mixed path's dynamic 4D map and the disparity path's merge
    "mixed": ("mixed", None, None, 512, {}, ("merge4d",), CAPTURE_STEP),
    # the staged wide-lane variants' paths (chip_smoke.py's run_wide): the
    # mixed full grid's dynamic map (both caps 0: merge4d_argmax_wide), the
    # dense full grid (merge2d_argmax_wide) and dense at K = 2048
    # (detect_wide), at the steps chip_smoke.py captures
    "mixed full grid": ("mixed", None, None, 512, MIXED_FULL, ("merge4d",),
                        40),
    "dense full grid": ("synth", *DENSE, {"merge_candidate_cap": 0},
                        ("merge2d",), 20),
    "dense K2048": ("synth", *DENSE, {"max_features": 2048}, ("detect",),
                    20),
    # detect_cons_adaptive_wide: dense at K = 2048 with the consolidating +
    # adaptive run's knobs
    "dense K2048 consolidating + adaptive": (
        "synth", *DENSE, dict(CONS_ADAPTIVE, max_features=2048),
        ("detect",), 20),
    "disparity": ("disparity", "cfg/disparity.cfg", "data/disparity", 512,
                  {}, ("merge3d",), 20),
}

# the mixed path's bench (tools/bench_mixed.py): configuration and scans
MIXED_STEPS, MIXED_DT = 100, 0.5


def mixed_cfg(P=512, K=128, M=32, **overrides):
    """tools/bench_mixed.py's mixed configuration (fast route, 4D stage-2
    cap 128, detection_topk 16 and merge_candidate_cap 512 by default),
    with ``overrides``."""
    from phdslam_tpu_torch import SlamConfig
    cfg = SlamConfig(
        n_particles=P, max_features=K, max_measurements=M,
        motion_type=0, feature_model=2, filter_type=0,
        vx0=1.5, vyaw0=0.2, ax=0.3, ayaw=0.03,
        max_range=12.0, std_range=0.5, std_bearing=0.02,
        clutter_rate=5.0, pd=0.95, birth_weight=0.05, min_separation=2.0,
        resample_threshold=0.5, particle_weighting=0, tau=0.2,
        cov_vx_birth=0.25, cov_vy_birth=0.25, std_ax_map=0.05,
        std_ay_map=0.05, merge_candidate_cap_dynamic=128, seed=0)
    return dataclasses.replace(cfg, **overrides)


def mixed_scans(T=MIXED_STEPS, M=32):
    """tools/bench_mixed.py's synthetic scans: range U(1, 11), bearing
    U(-1.5, 1.5), the first M - 8 slots valid, numpy seed 0."""
    rng = np.random.default_rng(0)
    zr = rng.uniform(1.0, 11.0, (T, M)).astype(np.float32)
    zb = rng.uniform(-1.5, 1.5, (T, M)).astype(np.float32)
    mask = np.broadcast_to(np.arange(M)[None, :] < max(4, M - 8),
                           (T, M)).copy()
    return np.stack([zr, zb], axis=-1), mask


def mixed_runner(dev, P=512, T=MIXED_STEPS, **overrides):
    """The mixed bench's ScanRunner at P particles over T scans (with
    ``overrides`` on its configuration)."""
    from phdslam_tpu_torch.slam import ScanRunner
    z, mask = mixed_scans(T)
    return ScanRunner(mixed_cfg(P, **overrides), z, mask, MIXED_DT,
                      device=dev)


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def capture_runner(dev, run, P=None):
    """(runner, the module whose wrappers it calls) of CAPTURED[run], at
    its own particle count or P."""
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filters import disparity, phd
    from phdslam_tpu_torch.slam import SynthSLAMRunner
    from phdslam_tpu_torch.slam_disparity import DisparityRunner
    kind, cfg_path, data, P0, overrides, _, _ = CAPTURED[run]
    P = P or P0
    if kind == "mixed":
        return mixed_runner(dev, P, **overrides), phd
    cfg = load_config(cfg_path, dict(overrides, n_particles=P))
    if kind == "disparity":
        return DisparityRunner(cfg, data, device=dev), disparity
    return SynthSLAMRunner(cfg, data, device=dev), phd


def capture_step(dev, run, step=None, P=None):
    """Runs CAPTURED[run] on ``dev`` from step 0 and returns ({wrapper name:
    (args, kwargs)} of that wrapper's first call in step ``step`` (default:
    the run's own), or in the first later step that calls it, each tensor
    cloned; the step captured). ``P`` overrides the particle count."""
    *_, names, own_step = CAPTURED[run]
    step = own_step if step is None else step
    r, module = capture_runner(dev, run, P)
    got = {}
    armed = False

    def spy(name, real):
        def call(*args, **kwargs):
            if armed and name not in got:
                got[name] = (_clone(args), _clone(kwargs))
            return real(*args, **kwargs)
        return call

    n = 0
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(
                module, name, spy(name, getattr(module, name))))
        while len(got) < len(names):
            if n >= r.n_steps:
                raise RuntimeError(f"capture {run}: no call of "
                                   f"{set(names) - set(got)} from step {step}")
            armed = n >= step
            r.step(n)
            n += 1
    return got, n - 1


def live_counts(count, z4, T):
    """The live counts of the rows with a valid measurement: min, median,
    p99, max and the share of rows with count <= T."""
    c = count[:, z4[:, 2] > 0.5].flatten().double()
    q = torch.quantile(c, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                       device=c.device))
    return {"rows": c.numel(), "min": int(c.min()), "median": float(q[0]),
            "p99": float(q[1]), "max": int(c.max()),
            "share_le_T": float((c <= T).double().mean())}


# ----------------------------------------------------------------------------
# bounds and the comparison with the twin
# ----------------------------------------------------------------------------

def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_err(pairs):
    """The largest |a - b| over the pairs where b is finite (0 if none)."""
    errs = [0.0]
    for a, b in pairs:
        d = (a.double() - b.double()).abs()[torch.isfinite(b)]
        if d.numel():
            errs.append(float(d.max()))
    return max(errs)


def bound(n_bytes, n_ops):
    """The least time (ms) the card could take: the larger of the bytes
    over HBM bandwidth and the f32 operations over the f32 peak, and which
    of the two it is."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def detect_bound(planes, z4, T, min_fw=0.0, cb=0.0, min_sep=0.0):
    """A detect variant's bound on these inputs (the arguments of
    :func:`detect`): its planes and z4 read once; vals, idx, norm and
    count (and cons [P, 10, K] with ``min_sep > 0``) written once; ~21 f32
    operations per (p, m, k) lane for pdw and its live test (one exp among
    them), and with consolidation ~17 more per live lane, the only lanes
    the column pass needs (w_det, the head test, the quadratic about the
    head, the member test and the moment sums)."""
    P, _, K = planes.shape
    M = z4.shape[0]
    n_ops = 21 * P * M * K
    if min_sep > 0:
        from phdslam_tpu_torch.kernels.detect import detection_grid
        _, _, pdw = detection_grid(planes, z4)
        thr = min_fw * (pdw.sum(dim=-1, keepdim=True) + cb)
        n_ops += 17 * int(((pdw >= thr) & (pdw > 0)).sum())
    return bound(4 * (planes.numel() + z4.numel()) + 8 * P * M * T
                 + 8 * P * M + (40 * P * K if min_sep > 0 else 0), n_ops)


def boundary_columns(planes, z4, min_fw, cb, rel=1e-5):
    """[P, K] feature columns whose consolidation f32 rounding can move
    between the card and the twin (exp and the row sums round differently):
    a lane within ``rel`` of the live threshold, or a head tie (the two
    heaviest live w_det, or the heaviest and the persistent wp, within
    ``rel``). The quadratics themselves are the same bits on both sides."""
    from phdslam_tpu_torch.kernels.detect import detection_grid
    _, _, pdw = detection_grid(planes, z4)
    norm = pdw.sum(dim=-1, keepdim=True) + cb
    thr = min_fw * norm
    edge = ((pdw - thr).abs() <= rel * thr).any(dim=1)
    wd = torch.where((pdw >= thr) & (pdw > 0), pdw / norm, 0.0)
    top2 = wd.topk(2, dim=1).values
    wp = planes[:, 6]
    tie = (top2[:, 0] > 0) & ((top2[:, 0] - top2[:, 1] <= rel * top2[:, 0])
                              | ((wp - top2[:, 0]).abs() <= rel * wp))
    return edge | tie


def compare_detect(got, want, label, planes=None, z4=None, min_fw=0.0,
                   cb=0.0):
    """A detect kernel's outputs against its twin's: norm and vals rtol
    1e-5 (NaN where the twin has NaN), idx where selected, the counts
    exactly and idx 0 where nothing is selected; with cons, the head
    coordinates, member counts and pers_in exactly and the sums rtol 1e-4
    / atol 1e-5. A column whose consolidation differs (a member flip) must
    be a boundary column (:func:`boundary_columns`); its column and the
    rows holding its live lanes are then left out. Returns (max |err|,
    flipped columns)."""
    from phdslam_tpu_torch.kernels.detect import detection_grid
    rows = torch.ones_like(want[3], dtype=torch.bool)            # [P, M]
    flips = 0
    if len(want) == 5:
        flip = (got[4][:, 6:] != want[4][:, 6:]).any(dim=1)        # [P, K]
        flips = int(flip.sum())
        if flips:
            edge = boundary_columns(planes, z4, min_fw, cb)
            require(not bool((flip & ~edge).any()),
                    f"{label}: consolidation differs in a column away from "
                    "an f32 boundary")
            _, _, pdw = detection_grid(planes, z4)
            rows = ~((pdw > 0) & flip[:, None, :]).any(dim=-1)
        keep = ~flip[:, None, :].expand_as(want[4])
        torch.testing.assert_close(got[4][keep], want[4][keep], rtol=1e-4,
                                   atol=1e-5, equal_nan=True)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(got[0][rows], want[0][rows], rtol=1e-5,
                               atol=0)
    sel = (want[0] > 0) & rows[..., None]
    require(torch.equal(got[1][sel], want[1][sel]), f"{label}: idx differs")
    require(bool((got[1][~(want[0] > 0) & rows[..., None]] == 0).all()),
            f"{label}: an unselected idx is not 0")
    require(torch.equal(got[3][rows], want[3][rows]),
            f"{label}: live count differs")
    pairs = [(got[0][rows], want[0][rows]), (got[2], want[2])] \
        + ([(got[4], want[4])] if len(want) == 5 and not flips else [])
    return max_err(pairs), flips


def digest(tensors):
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


# ----------------------------------------------------------------------------
# the timed cases
# ----------------------------------------------------------------------------

# name: (source, variant). source: ("scene", config, P, K, M, valid, T) on
# eval/scenes.py::map_scene (seed 0), or ("captured", run) from
# capture_step; variant: (consolidating, adaptive, min_fw and cb from the
# config or 0 and 0)
_ACK_SCENE = ("scene", "cfg/ackerman.cfg", 512, 128, 48, 44, 16)
_MIXED_SCENE = ("scene", "cfg/ackerman.cfg", 512, 128, 32, 24, 16)
_DENSE_SCENE = ("scene", "cfg/dense.cfg", 1024, 1024, 72, 65, 32)
_K2048_SCENE = ("scene", "cfg/dense.cfg", 1024, 2048, 72, 65, 32)
DETECT_TIMED = {
    "ackerman": (_ACK_SCENE, (False, False, True)),
    "ackerman adaptive": (_ACK_SCENE, (False, True, True)),
    "ackerman cons": (_ACK_SCENE, (True, False, True)),
    "CPHD min_fw 0 cb 0": (_ACK_SCENE, (False, False, False)),
    "mixed static M 32 min_fw 0 cb 0": (_MIXED_SCENE, (False, False, False)),
    "dense": (_DENSE_SCENE, (False, False, True)),
    "dense adaptive": (_DENSE_SCENE, (False, True, True)),
    "dense cons": (_DENSE_SCENE, (True, False, True)),
    "dense cons adaptive": (_DENSE_SCENE, (True, True, True)),
    "ackerman captured": (("captured", "ackerman"), None),
    "dense captured": (("captured", "dense"), None),
    "dense adaptive captured": (("captured", "dense fused + adaptive"),
                                None),
    "dense cons adaptive captured": (
        ("captured", "dense consolidating + adaptive"), None),
    # detect_wide, the path at max_features 2048
    "dense K2048": (_K2048_SCENE, (False, False, True)),
    "dense K2048 captured": (("captured", "dense K2048"), None),
    # detect_cons_wide and detect_cons_adaptive_wide at the same widths
    "dense K2048 cons": (_K2048_SCENE, (True, False, True)),
    "dense K2048 cons adaptive": (_K2048_SCENE, (True, True, True)),
    "dense K2048 cons adaptive captured": (
        ("captured", "dense K2048 consolidating + adaptive"), None),
}


def scene_args(dev, source, variant):
    """(planes, z4, T, min_fw, cb, min_sep, adaptive) of a scene case."""
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.eval.scenes import detect_planes, map_scene
    _, path, P, K, M, n_valid, T = source
    cons, adaptive, thresholded = variant
    cfg = load_config(path)
    s = map_scene(cfg, P, K, M, n_valid, seed=0, device=dev)
    planes, z4 = detect_planes(cfg, s, consolidate=cons)
    min_fw, cb = ((cfg.min_feature_weight,
                   cfg.clutter_density + cfg.birth_weight) if thresholded
                  else (0.0, 0.0))
    return (planes, z4, T, min_fw, cb,
            cfg.min_separation if cons else 0.0, adaptive)


def captured_args(call):
    """The same tuple from a captured detect call (args, kwargs)."""
    args, kw = call
    planes, z4, T, min_fw, cb = args
    return (planes, z4, T, min_fw, cb, kw.get("min_sep", 0.0),
            kw.get("adaptive", False))


def check_case(name, a, wide=None):
    """The kernel against its twin on one case's arguments (``wide=True``:
    the wide variant forced); returns (outputs, launch name, max |err|,
    member flips)."""
    from phdslam_tpu_torch.kernels import build
    from phdslam_tpu_torch.kernels import detect as kdetect
    from phdslam_tpu_torch.kernels.detect import (detect, detect_reference,
                                                  detect_variant)
    planes, z4, T, min_fw, cb, min_sep, adaptive = a
    build.reset_launch_counts()
    got = detect(*a, wide=True) if wide else detect(*a)
    torch.cuda.synchronize()
    launched = dict(build.launch_counts)
    # a checkout without the wide variants has no NARROW_FEATURES
    narrow = getattr(kdetect, "NARROW_FEATURES", planes.shape[2])
    want_name = detect_variant(min_sep > 0, adaptive) \
        + ("_wide" if wide or planes.shape[2] > narrow else "")
    require(launched == {want_name: 1},
            f"{name}: launched {launched}, not {want_name}")
    want = detect_reference(planes, z4, T, min_fw, cb, min_sep)
    err, flips = compare_detect(got, want, name, planes, z4, min_fw, cb)
    return got, want_name, err, flips


def main():
    ap = bench_parser(__doc__)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--expect", help="JSON lines of another run whose "
                    "output digests every case must repeat")
    args = ap.parse_args()
    card = open_checkout("detect_bench.py", args.root)
    from phdslam_tpu_torch.kernels.detect import detect
    expect = {}
    if args.expect:
        with open(args.expect) as f:
            expect = {d["case"]: d["out_sha"] for d in map(json.loads, f)}
    dev = torch.device("cuda:0")
    captured = {}
    lines = []
    mismatched = []

    def emit(line):
        line["matches_expected"] = None
        if expect:
            line["matches_expected"] = expect.get(line["case"]) == line[
                "out_sha"]
            if not line["matches_expected"]:
                mismatched.append(line["case"])
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)

    for name, (source, variant) in DETECT_TIMED.items():
        if source[0] == "scene":
            a = scene_args(dev, source, variant)
            step = None
        else:
            if source[1] not in captured:
                captured[source[1]] = capture_step(dev, source[1])
            calls, step = captured[source[1]]
            a = captured_args(calls["detect"])
        planes, z4, T, min_fw, cb, min_sep, adaptive = a
        got, launched, err, flips = check_case(name, a)
        fn = lambda a=a: detect(*a)
        calls_ms = [time_call(fn) for _ in range(2)]
        b_ms, b_by = detect_bound(*a[:6])
        emit({"label": args.label, "case": name, "launched": launched,
              "step": step, "P": planes.shape[0], "K": planes.shape[2],
              "M": z4.shape[0], "T": T, "call_ms": min(calls_ms),
              "graph_ms": graph_ms(fn), "bound_ms": b_ms, "bound_by": b_by,
              "live": live_counts(got[3], z4, T), "max_abs_err": err,
              "member_flips": flips, "out_sha": digest(got),
              "in_sha": digest((planes, z4)), "card": card})
    for name in DETECT_EDGES:
        for cons in (False, True):
            planes, z4, T, min_fw, cb = (torch.from_numpy(x).to(dev)
                                         if isinstance(x, np.ndarray) else x
                                         for x in detect_edge_case(name,
                                                                   cons))
            for adaptive in (False, True):
                for wide in (None, True):
                    a = (planes, z4, T, min_fw, cb,
                         MIN_SEP_EDGES if cons else 0.0, adaptive)
                    got, launched, err, flips = check_case(name, a, wide)
                    emit({"label": args.label, "case": f"edge {name} "
                          f"{launched}", "launched": launched,
                          "live": live_counts(got[3], z4, T),
                          "max_abs_err": err, "member_flips": flips,
                          "out_sha": digest(got), "card": card})
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(f"{line}\n" for line in lines))
    if mismatched:
        sys.exit(f"detect_bench.py: outputs differ from {args.expect} at "
                 f"{mismatched}")


if __name__ == "__main__":
    main()
