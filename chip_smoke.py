"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``phdslam_tpu_torch/csrc``, holds each
against its plain PyTorch twin at the shapes of the two ported paths, and
drives both paths:

- Ackerman GM-PHD (static 2D map): one filter step on the card against the
  same step on the CPU, the full ``data/ackerman`` sequence at P=512 and
  the first 60 steps at P=10240;
- mixed jump-Markov (CV vehicle, static 2D + dynamic 4D maps, the JAX
  package's ``tools/bench_mixed.py`` configuration): one step on the card
  against the CPU, 100 steps at P=512 and 30 at P=10240, and the accuracy
  of ``evaluate_mixed`` over five seeds at P=256;
- monocular SC-PHD (disparity, ``cfg/disparity.cfg``): one step on the
  card against the CPU, the 80 frames of ``data/disparity`` at P=512, the
  JAX package's disparity bench rows (``bench.py::_disparity_row``: a
  generated world, 60 frames) at P=200 and P=512, full-SLAM accuracy of
  ``evaluate_disparity`` over five seeds at P=512 and known-pose mapping
  at seed 0;
- CPHD (``cfg/ackerman_cphd.cfg``): one step on the card against the CPU,
  the full ``data/ackerman`` sequence at P=512 (ATE and every-step OSPA)
  and the first 60 steps at P=10240;
- the full-grid (uncapped) route, ``merge_candidate_cap = 0``: the
  Ackerman PHD and CPHD configurations on ``data/ackerman`` at P=512, then
  both CPHD routes again at seeds 1-3;
- the Hellinger merge distance (``distance_metric = 1``, min_separation
  0.6): 100 steps of the Ackerman configuration, then 30 on the full grid,
  then 100 on the fused gather + merge;
- the kernel knobs: ``fused_gather_merge`` with ``detect_adaptive`` (the
  full ``data/ackerman`` run at P=512, which must reproduce the plain run's
  mean ATE within 1e-3 m) and ``premerge_consolidate`` (Ackerman P=512 and
  one step against the CPU);
- the dense configuration (``cfg/dense.cfg`` on ``data/dense``: K=1024,
  T=32, cap 1536, M padded to the longest scan): one step of a 64-particle
  subset on the card against the CPU for each of plain, fused + adaptive and
  consolidating + adaptive, the 200 steps at P=1024 for each, fused +
  adaptive at P=10240 twice (every pose must repeat), each stage of one
  P=10240 step twice with its peak memory, the P=10240 run twice more with
  the resampling's former 1D scan, and the JAX package's CPU runs'
  particle counts and seeds (P=64 and P=256) beside their results;
- the remaining estimators and routes of the PHD/CPHD step on
  ``data/ackerman`` at P=512: one step on the card against the CPU for
  each of scheme-2 weighting, the MC map variance (det route; the full
  grid at step 5), shotgunning k=3, detection_topk 128 >= K with cap 512
  (PHD and CPHD) and EAP extraction (each tree level's merge2d against
  its twin on its inputs); the EAP runs at eap_every 1 and 5 and on the
  dense configuration at P=1024 (every pose bit-equal to the plain run,
  log2 P merge2d launches a step beyond it), one EAP extraction at
  P=10240 (``tools/bench_eap.py``'s scene), the variance run (bit-equal
  poses, finite estimates), shotgunning twice (bit-equal) and on the
  mixed fast route at k=2, both T >= K filters, 100 scheme-2 steps, and
  the EAP, MAP, shotgun and T >= K accuracy beside the JAX package's
  CPU runs of the same particle count and seeds;

- the options the filters once refused: the mixed model's
  per-particle route (``mixed_fast_path = 0``) at the mixed bench's width
  (P=512, K=128, M=32) over its 100 scans, merge2d's and merge4d's argmax
  modes required, then weighting 2 and compute_variance 30 steps each,
  one of its steps against the CPU and against the fast route on the
  card, and ``evaluate_mixed`` over seeds 0-4 at P=256 with each of
  mixed_fast_path=0, birth_velocity_init=1, distance_metric=1 and
  feature_model=1 beside the JAX package's CPU runs; static Vo weighting
  (particle_weighting 1) on data/ackerman's three routes, CPHD with
  compute_variance (poses bit-equal to plain CPHD), and data/disparity at
  weighting 2 and with the Hellinger merge (merge3d_hellinger);

- the spatially tiled merge (``merge_spatial_tiles = 4``): its two
  launches (the tile extraction through gather_cols, merge2d on the
  [4 P, 7, ct] tile rows) on the captured inputs of step 60 of the dense
  configuration at P=1024 against their twins, one step with tiles on of
  the dense (64 of P=1024), Ackerman, CPHD and mixed paths against the
  CPU (the same tiled-or-untiled choices at the same widths on both),
  data/ackerman P=512 and data/dense P=1024 untiled then tiled
  (steps/s, ATE, OSPA, tiled launches, untiled fallbacks), and
  Ackerman P=128 seeds 0-4 tiled beside the JAX package's tiled CPU runs;
  the mixed accuracy runs through ``evaluate_mixed_mc`` (detection by
  speed too), and disparity clouds of one point (NaN, reported) run on
  the card and the CPU;

- the runtime around the runner: ``python -m phdslam_tpu_torch``'s
  ``main`` on the full ``data/ackerman`` sequence at P=512 (331 state
  logs scored by ``eval/batch.py::analyze_log_dir`` and byte-equal to
  the Python writer's, checkpoints every 160 steps, the resume from step
  160 byte-equal), 60 steps ``--timing``
  (poses bit-equal), 20 steps ``--trace`` (the kernels' device events),
  ``--profile``'s single update, the ``disparity`` run type, a four-run
  Monte-Carlo batch (``tools/mc_scale.py``'s PHD P=1024) and a run with
  NaN weights injected at step 20 (reported, not raised; raised under
  ``debug``);

then times every kernel against its twin (the knob variants and the
existing kernels at the dense shapes too, the two gathers at every shape
the paths launch, each with ``torch.gather`` beside it, and the update's
kernels on the inputs captured from step 60 of the dense, Ackerman and
mixed runs and frame 20 of the disparity run,
``detect_bench.capture_step``; merge2d at the EAP tree's first level on
step 60's maps of the Ackerman and dense runs) and profiles a step of
each path (and of the Ackerman and dense runs under EAP).
The detect kernel is also held against its twin at the selection's
edges (``detect_bench.DETECT_EDGES``), and the merges at theirs
(``merge_bench.MERGE_EDGES``: every merge2d variant, merge2d_tables,
merge3d and merge4d in each of their variants). merge4d's argmax mode is
timed on the dynamic merge's inputs at step 60 of the per-particle route,
and the 3D / 4D Hellinger variants on the mixed and disparity steps'
captured inputs. The gathers are held bit for bit
against their twins at those shapes and at unaligned, ragged,
out-of-range and above-budget cases, each of their two modes (the slab
staged in shared memory, or read through ``__ldg``) counted under its
own name.
The ``wide`` phase holds the dense full grid's merge2d_argmax_wide on the
whole captured P=1024 launch (the path's plan) against the twin on the
lanes that enter, and its first 8 particles alone against the twin, times
the whole launch, and prints each redesigned staged kernel's plan at its
path shape; ``[parallel cphd4]`` must repeat the 1-process CPHD step bit
for bit on every step.
Each phase prints its result; any failure raises and exits non-zero.
After the ``[total]`` line, ``[phases]`` gives each phase's wall time
(``phase_times.py``, which times an older checkout's script the same
way). Each
path's run resets the launch counts before it and requires every kernel
variant of that path to have launched. The line before the card's name
and power limit lists every kernel variant (the merge2d kernel's four:
sorted or argmax principal, Mahalanobis or Hellinger; each gather's two
modes) with its launches
in the first path that runs it, its error against its twin, its time per
eager call, its twin's, its bound and, where one PyTorch call computes the
same function, that call's time; the kernel's and the library call's
device times beside them. The last line is one JSON object naming the
device.
Needs a CUDA device, ``gather_bench.py`` (the gathers' cases and the
timing helpers), ``detect_bench.py`` (the detect kernels' edge cases,
the step capture and the comparison with the twin), ``merge_bench.py``
and ``phase_times.py`` beside it; imports no jax.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from detect_bench import (DETECT_EDGES, MIN_SEP_EDGES, MIXED_DT,
                          MIXED_STEPS, bound, capture_step, captured_args,
                          check_case, compare_detect, detect_bound,
                          detect_edge_case, live_counts, max_err, mixed_cfg,
                          mixed_runner, mixed_scans, require)
from gather_bench import (GATHER_CASES, GATHER_TIMED, card_name, cycling,
                          gather_bound, gather_case, gather_sets, graph_ms,
                          time_call)
from merge_bench import (DISP_SEP, HELL_SEP, MERGE_EDGES, MIN_SEP,
                         MIXED_SEP, OUT_PLANES, check_merge_rows, edge_runs,
                         entering_planes,
                         full_grid_inputs, merge3d_inputs, merge4d_inputs,
                         merge_bound, merge_inputs, merge_rounds,
                         round_stats, run_case, tables_bound,
                         tables_edge_case)
from phase_times import phases_line, time_phases
from phdslam_tpu_torch import SlamConfig, load_config
from phdslam_tpu_torch.__main__ import main as cli_main
from phdslam_tpu_torch.eval import simdata
from phdslam_tpu_torch.eval.batch import (analyze_log_dir,
                                          generate_batch_datasets, run_batch)
from phdslam_tpu_torch.eval.ospa import ospa_distance
from phdslam_tpu_torch.eval.parity import (disparity_map_estimate,
                                           evaluate_dataset,
                                           evaluate_disparity, evaluate_mixed,
                                           evaluate_mixed_mc)
from phdslam_tpu_torch.eval.scenes import (Scene, detect_planes, map_scene,
                                           tables_payload)
from phdslam_tpu_torch.filters import disparity as disp
from phdslam_tpu_torch.filters import extras
from phdslam_tpu_torch.filters import phd as phd_filter
from phdslam_tpu_torch.filters.phd import (StepNoise,
                                           _finish_candidates_packed,
                                           _post_compact_batched,
                                           _update_pre, expand_particles,
                                           extract, gather_merge,
                                           maybe_resample, predict,
                                           resample_particles, update)
from phdslam_tpu_torch.kernels import build
from phdslam_tpu_torch.kernels.cardinality import (
    cardinality_predict_batch, cardinality_predict_reference)
from phdslam_tpu_torch.kernels.detect import (NARROW_FEATURES, detect,
                                              detect_reference,
                                              detect_variant,
                                              detect_wide_plan)
from phdslam_tpu_torch.kernels.gather_cols import (gather_cols,
                                                   gather_cols_reference)
from phdslam_tpu_torch.kernels.gather_rows import (gather_rows,
                                                   gather_rows_reference)
from phdslam_tpu_torch.kernels.merge import (NARROW_LANES, merge2d,
                                             merge2d_plan, merge2d_reference,
                                             merge2d_tables,
                                             merge2d_tables_reference,
                                             merge2d_variant, merge3d,
                                             merge3d_reference, merge4d,
                                             merge4d_reference, merge_plan,
                                             recip_check,
                                             tables_packed)
from phdslam_tpu_torch.filters import mixed as mixed_filter
from phdslam_tpu_torch.ops import gm_merge as tgm
from phdslam_tpu_torch.ops.gm_merge import MERGE_DIMS, merge_out, sort_planes
from phdslam_tpu_torch.ops import resample
from phdslam_tpu_torch.parallel.sim import run_group
from phdslam_tpu_torch.ops.math import logsumexp
from phdslam_tpu_torch.runtime import io as rt_io
from phdslam_tpu_torch.runtime.checkpoint import profile_single_update
from phdslam_tpu_torch.slam import ScanRunner, SynthSLAMRunner
from phdslam_tpu_torch.slam_disparity import DisparityRunner
from phdslam_tpu_torch.types import DisparityState, FilterState, GMState

CFG = "cfg/ackerman.cfg"
DATA = "data/ackerman"
P_MAIN = 512
P_SCALE, SCALE_STEPS = 10240, 60
ATE_LIMIT = 1.0                 # m: loose sanity bound (own noise stream)
ATE_BAND = (0.40, 0.51)         # m: the JAX reference's band at P=512

# the mixed path: tools/bench_mixed.py's configuration and scans
# (detect_bench.mixed_runner)
P_MIXED_SCALE, MIXED_SCALE_STEPS = 10240, 30
MIXED_SEEDS, P_MIXED_ACC = range(5), 256
# the JAX package's 50-run mixed accuracy, mean and std (BENCH.md,
# "Round-3: mixed jump-Markov Monte-Carlo acceptance")
MIXED_BANDS = {"mean_pose_err": (0.14, 0.08), "static_ospa": (1.90, 0.35),
               "dynamic_ospa": (3.30, 1.40)}

# the disparity path: cfg/disparity.cfg (K=24 slots of N=32 points, M=24
# after padding the 28-measurement longest scan of data/disparity, cap 512)
DISP_CFG, DISP_DATA = "cfg/disparity.cfg", "data/disparity"
DISP_BENCH_P, DISP_BENCH_STEPS = (200, 512), 60
DISP_SEEDS, P_DISP_ACC = range(5), 512
# the JAX package's disparity accuracy (BENCH.md, "Round-5: disparity
# full-SLAM accuracy", P=512 over 5 generated worlds; known-pose mapping at
# seed 0): mean and std
DISP_BANDS = {"mean_pose_err": (0.721, 0.043), "ospa": (0.86, 0.03)}
DISP_KNOWN_POSE_OSPA = 0.90

# the CPHD path and the full-grid / Hellinger variants
CPHD_CFG = "cfg/ackerman_cphd.cfg"
CPHD_C1 = 65                    # its max_cardinality + 1
# the JAX package on the CPU, cfg/ackerman_cphd.cfg at P=512 over the full
# dataset, seeds 0-2 (reference_band.py): mean ATE and mean every-step
# OSPA(1, 5), mean and std over the seeds
CPHD_BAND = {"ate": (0.4415, 0.1649), "ospa": (1.5284, 0.1255)}
# the same with merge_candidate_cap 0 (reference_band.py --set
# merge_candidate_cap=0), seeds 0-2
CPHD_FULL_BAND = {"ate": (0.4909, 0.0562), "ospa": (1.6151, 0.0591)}
FULL_GRID_STEPS = None          # None: the whole dataset
CPHD_SEEDS = (1, 2, 3)          # both CPHD routes, beside seed 0's runs
HELL = {"distance_metric": 1, "min_separation": 0.6}
HELL_STEPS, HELL_FULL_STEPS = 100, 30

# the kernel knobs and the dense configuration
FUSED_ADAPTIVE = {"fused_gather_merge": 1, "detect_adaptive": 1}
CONS = {"premerge_consolidate": 1}
ATE_REPRO = 1e-3                # m: fused + adaptive against the plain run
DENSE_CFG, DENSE_DATA = "cfg/dense.cfg", "data/dense"
P_DENSE, P_DENSE_SCALE = 1024, 10240
P_DENSE_STEP = 64               # the particle subset of the dense step gate
DENSE_VARIANTS = {"plain": {}, "fused + adaptive": FUSED_ADAPTIVE,
                  "consolidating + adaptive": dict(CONS, detect_adaptive=1)}
# the JAX package's dense rows (ROADMAP.md, "Held against the reference"):
# P=1024 ATE 0.27-0.36 m, OSPA 1.19-1.28; P=10240 0.307 m, 1.153
DENSE_BAND = {"ate": (0.27, 0.36), "ospa": (1.19, 1.28)}
DENSE_SCALE_REF = {"ate": 0.307, "ospa": 1.153}
# the JAX package on the CPU, cfg/dense.cfg over the full dataset, one
# line per seed from 0 (reference_band.py cfg/dense.cfg --particles P
# --seeds ...): mean ATE (m), mean every-step OSPA(1, 5)
DENSE_CPU_SEEDS = {
    64: [(0.4116, 1.1712), (0.7735, 1.4136), (0.6596, 1.3130),
         (0.6295, 1.3053), (0.4947, 1.2343), (0.1766, 1.0414),
         (0.2332, 1.0787), (0.2300, 1.0695), (0.2999, 1.1144),
         (1.1501, 1.6768), (0.4447, 1.2299), (0.1329, 1.0311),
         (0.2842, 1.1154), (0.4215, 1.1680), (0.7085, 1.3656),
         (0.2341, 1.0825), (0.3498, 1.1305), (0.3032, 1.1126),
         (0.2018, 1.0687), (0.2510, 1.0773)],
    256: [(0.5235, 1.2305), (0.6813, 1.3474), (0.2138, 1.0592),
          (0.1601, 1.0372), (0.1383, 1.0461), (0.2052, 1.0549),
          (0.2366, 1.0996), (0.2075, 1.0560)],
}
# the kernel phase's shapes of the knob variants: config, P, K, M (the
# padded longest scan), valid measurements, T
VARIANT_SHAPES = {"ackerman": (CFG, P_MAIN, 128, 48, 44, 16),
                  "dense": (DENSE_CFG, P_DENSE, 1024, 72, 65, 32)}

_MERGE2D = ("phdslam_tpu_torch/csrc/merge2d.cu",
            "phdslam_tpu/ops/pallas_merge.py:55")
_DETECT = "phdslam_tpu_torch/csrc/detect.cu"
_TABLES = (_MERGE2D[0], "phdslam_tpu/ops/pallas_merge.py:417")
# the gathers' two modes, counted under two names: the per-particle slab
# staged in shared memory, or (above build.GATHER_SMEM_BUDGET) read through
# __ldg
_COLS = ("phdslam_tpu_torch/csrc/gather_cols.cu",
         "phdslam_tpu/ops/pallas_select.py:46")
_ROWS = ("phdslam_tpu_torch/csrc/gather_rows.cu",
         "phdslam_tpu/ops/pallas_select.py:118")
KERNELS = {
    "detect": (_DETECT, "phdslam_tpu/ops/pallas_detect.py:49"),
    "detect_adaptive": (_DETECT, "phdslam_tpu/ops/pallas_detect.py:166"),
    "detect_cons": (_DETECT, "phdslam_tpu/ops/pallas_detect.py:111"),
    "detect_cons_adaptive": (_DETECT, "phdslam_tpu/ops/pallas_detect.py:111"),
    "gather_cols": _COLS,
    "gather_cols_ldg": _COLS,
    "gather_rows": _ROWS,
    "gather_rows_ldg": _ROWS,
    "merge2d": _MERGE2D,
    "merge2d_argmax": _MERGE2D,
    "merge2d_hellinger": _MERGE2D,
    "merge2d_argmax_hellinger": _MERGE2D,
    "merge2d_tables": _TABLES,
    "merge2d_tables_hellinger": _TABLES,
    "merge4d": ("phdslam_tpu_torch/csrc/merge4d.cu",
                "phdslam_tpu/ops/pallas_merge.py:785"),
    "merge3d": ("phdslam_tpu_torch/csrc/merge3d.cu",
                "phdslam_tpu/ops/pallas_merge.py:576"),
    # the argmax mode of _merge_kernel_4d (sorted_w=False, :845-858), the
    # mode gm_merge_pallas_one_4d runs on the mixed per-particle route
    "merge4d_argmax": ("phdslam_tpu_torch/csrc/merge4d.cu",
                       "phdslam_tpu/ops/pallas_merge.py:845"),
    # the JAX package merges 3D / 4D mixtures under the Hellinger distance
    # in XLA's gm_merge (no Pallas kernel there): the function replaced
    "merge4d_hellinger": ("phdslam_tpu_torch/csrc/merge4d.cu",
                          "phdslam_tpu/ops/gm_merge.py:35"),
    "merge3d_hellinger": ("phdslam_tpu_torch/csrc/merge3d.cu",
                          "phdslam_tpu/ops/gm_merge.py:35"),
    # the CPHD cardinality prediction in one launch, its product in one
    # fixed order (the JAX package's XLA max, exp, dot and log there, no
    # Pallas kernel)
    "cardinality_predict": ("phdslam_tpu_torch/csrc/cardinality.cu",
                            "phdslam_tpu/filters/cphd.py:87"),
}
# the staged wide-lane variants: each merge and detect variant's, counted
# under its name with "_wide" appended (the merges' round core in
# merge_wide.cuh, instantiated in merge2d.cu, merge3d.cu and merge4d.cu)
_WIDE = "phdslam_tpu_torch/csrc/merge_wide.cuh"
KERNELS.update({f"{name}_wide": (_DETECT if name.startswith("detect")
                                 else _WIDE, rep)
                for name, (_, rep) in list(KERNELS.items())
                if name.startswith(("detect", "merge"))})
ACKERMAN_KERNELS = ("detect", "gather_cols", "merge2d")
KNOB_KERNELS = ("detect_adaptive", "gather_cols", "merge2d_tables")
CONS_KERNELS = ("detect_cons", "gather_cols", "merge2d")
DENSE_KERNELS = {"plain": ACKERMAN_KERNELS, "fused + adaptive": KNOB_KERNELS,
                 "consolidating + adaptive": ("detect_cons_adaptive",
                                              "gather_cols", "merge2d")}
HELL_FUSED_KERNELS = ("detect", "gather_cols", "merge2d_tables_hellinger")
MIXED_KERNELS = ACKERMAN_KERNELS + ("merge4d",)
DISP_KERNELS = ("merge3d",)
CPHD_KERNELS = ACKERMAN_KERNELS + ("cardinality_predict",)
FULL_GRID_KERNELS = ("merge2d_argmax",)
HELL_KERNELS = ("detect", "gather_cols", "merge2d_hellinger")
HELL_FULL_KERNELS = ("merge2d_argmax_hellinger",)
TOPK_KERNELS = ("gather_cols", "merge2d")
MIXED_SLOW_KERNELS = ("merge2d_argmax", "merge4d_argmax")
MIXED_HELL_KERNELS = ("merge2d_argmax_hellinger", "merge4d_hellinger")
DISP_HELL_KERNELS = ("merge3d_hellinger",)

# the mixed model's per-particle route (mixed_fast_path 0) on the mixed
# bench's scans, then weighting 2 and compute_variance, which take it too
SLOW = {"mixed_fast_path": 0}
SLOW_STEPS, SLOW_OPTION_STEPS = 100, 30
# evaluate_mixed with these overrides over MIXED_SEEDS at P_MIXED_ACC,
# beside the JAX package's CPU runs of the same seeds and overrides
# (reference_band.py mixed --particles 256 --seeds 0 1 2 3 4 --set ...):
# per override, (pose error, static OSPA, dynamic OSPA) per seed (NaN: no
# mover in range at the last step)
MIXED_OPTIONS = {"mixed_fast_path=0": {"mixed_fast_path": 0},
                 "birth_velocity_init=1": {"birth_velocity_init": 1},
                 "distance_metric=1": dict(HELL),
                 "feature_model=1": {"feature_model": 1}}
NAN = float("nan")
MIXED_OPTION_CPU = {
    "mixed_fast_path=0": [(0.0454, 1.7478, 0.2486), (0.0724, 1.6750, 2.6065),
                          (0.0952, 2.0222, NAN), (0.1432, 2.1254, NAN),
                          (0.0922, 1.8256, NAN)],
    "birth_velocity_init=1": [(0.0463, 1.6099, 0.0870),
                              (0.1072, 1.4607, 3.4523),
                              (0.1170, 2.0100, NAN), (0.0851, 1.9249, NAN),
                              (0.1197, 1.8387, NAN)],
    "distance_metric=1": [(0.0508, 1.9956, 0.2296), (0.0863, 1.6464, 2.8142),
                          (0.0521, 1.3993, NAN), (0.0824, 1.9917, NAN),
                          (0.1159, 1.8424, NAN)],
    "feature_model=1": [(0.5131, 5.0, 4.8193), (0.4424, 5.0, 4.7211),
                        (0.6106, 5.0, NAN), (0.8003, 5.0, NAN),
                        (0.5524, 5.0, NAN)]}
# static Vo weighting (particle_weighting 1) on data/ackerman: the det
# route, the top-cap lane route and the full grid, beside the JAX CPU band
# of reference_band.py cfg/ackerman.cfg --particles 512 --seeds 0 1 2
# --steps 100 --set particle_weighting=1
W1 = {"particle_weighting": 1}
W1_STEPS, W1_FULL_STEPS = 100, 30
W1_CPU_BAND = {"ate": (1.7567, 0.3736), "ospa": (2.5092, 0.1767)}

# the estimators and routes: EAP extraction, scheme-2 weighting, the MC
# map variance, shotgunning and the top-cap lane route (T >= K)
EAP = {"map_estimate": 2}
S2 = {"particle_weighting": 2}
S2_STEPS = 100
VAR = {"compute_variance": True}
VAR_FULL = dict(VAR, merge_candidate_cap=0)
SHOT = {"n_predict_particles": 3}
TOPK = {"detection_topk": 128}
# the JAX package on the CPU over the full data/ackerman sequence
# (reference_band.py CFG --particles P --seeds ... --set ...): mean ATE
# (m) and mean every-step OSPA(1, 5), mean and std over the seeds
# P=128, seeds 0-4: the plain configuration, --set map_estimate=2 (the
# same states: the EAP map's OSPA) and --set n_predict_particles=3
P_BAND, BAND_SEEDS = 128, range(5)
PLAIN_CPU_BAND = {"ate": (0.6997, 0.3167), "ospa": (2.0184, 0.1252)}
EAP_CPU_BAND = {"ate": (0.6997, 0.3167), "ospa": (1.9818, 0.1340)}
SHOT_CPU_BAND = {"ate": (0.7631, 0.1901), "ospa": (2.0885, 0.0636)}
# P=512, seeds 0-2: --set detection_topk=128 on cfg/ackerman.cfg and on
# cfg/ackerman_cphd.cfg
TOPK_SEEDS = range(3)
TOPK_CPU_BAND = {"ate": (0.4039, 0.0661), "ospa": (1.9135, 0.0460)}
TOPK_CPHD_CPU_BAND = {"ate": (0.3821, 0.1519), "ospa": (1.5291, 0.0885)}


CARD = ""                       # nvidia-smi's name and power limit


def phase(name, msg):
    """One result line, tagged with the card's name and power limit."""
    print(f"[{name}] {msg}" + (f" [{CARD}]" if CARD else ""), flush=True)


def clean(res, label):
    """A runner's result with no NaN weights: the runners report the first
    NaN step after the run (res["nan_step"]) and return; fail on one."""
    require(res["nan_step"] is None,
            f"{label}: NaN weights from step {res['nan_step']}")
    return res



# ----------------------------------------------------------------------------
# inputs at the main path's shapes, from a seed
# ----------------------------------------------------------------------------

def detect_inputs(dev, P=P_MAIN, K=128, M=48, n_valid=44, seed=0):
    rng = np.random.default_rng(seed)
    planes = np.stack([
        rng.uniform(1, 10, (P, K)), rng.uniform(-np.pi, np.pi, (P, K)),
        rng.uniform(0.5, 4.0, (P, K)), rng.uniform(-0.2, 0.2, (P, K)),
        rng.uniform(0.5, 4.0, (P, K)),
        np.where(rng.uniform(size=(P, K)) < 0.7,
                 rng.uniform(0.01, 1.0, (P, K)), 0.0)], axis=1)
    z4 = np.stack([rng.uniform(1, 10, M), rng.uniform(-np.pi, np.pi, M),
                   (np.arange(M) < n_valid).astype(float), np.zeros(M)],
                  axis=1)
    return (torch.tensor(planes, dtype=torch.float32, device=dev),
            torch.tensor(z4, dtype=torch.float32, device=dev))


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------

def check_device():
    require(torch.cuda.is_available(), "no CUDA device")
    smi = card_name()
    phase("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    global CARD
    CARD = smi
    return smi


def build_kernels():
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    took = time.perf_counter() - t0
    regs = [ln.strip() for ln in build.last_build_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    for ln in regs:
        phase("build", ln)
    phase("build", f"{path} ready in {took:.2f} s")


def check_merge2d(planes, min_sep, K, sorted_w, metric, label):
    """One merge2d variant against its twin: equal cluster and leftover
    counts, rtol 1e-4 / atol 1e-5 on weights, means and covariances.
    Returns (max |err|, the kernel's merge tuple)."""
    got = merge_out(merge2d(planes, min_sep, K, sorted_w, metric), 2)
    torch.cuda.synchronize()
    want = merge_out(merge2d_reference(planes, min_sep, K, sorted_w, metric),
                     2)
    require(torch.equal(got[3], want[3]), f"{label}: n_merged differs")
    require(torch.equal(got[4], want[4]), f"{label}: n_unmerged differs")
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    err = max_err(list(zip(got[:3], want[:3])))
    phase("kernels", f"{label}: clusters/particle "
          f"{float(got[3].float().mean()):.1f}, left "
          f"{float(got[4].float().mean()):.1f}, max |err| {err:.3g} "
          "(rtol 1e-4, atol 1e-5)")
    return err, got


def check_merge2d_variants(dev, errs, min_sep):
    """merge2d's argmax mode at the full grid's shapes in both metrics (the
    256-thread build), the Hellinger metric in sorted mode at the det
    route's N=512, both sorted variants above N=2048 (the 256-thread
    build a det-route cap above 2048 takes), an argmax Hellinger case at
    N=512 (the 64-thread build), and an overflow and a NaN case in argmax
    mode."""
    planes = full_grid_inputs(dev)
    frac = float((planes[:, 1] > 0.5).float().mean())
    h_sep = HELL["min_separation"]
    errs["merge2d_argmax"], _ = check_merge2d(
        planes, min_sep, 128, False, 0,
        f"merge2d argmax P={P_MAIN} N=6320 K=128 ({100 * frac:.1f}% active)")
    errs["merge2d_argmax_hellinger"], _ = check_merge2d(
        planes, h_sep, 128, False, 1,
        f"merge2d argmax hellinger P={P_MAIN} N=6320 K=128 "
        f"({100 * frac:.1f}% active)")
    errs["merge2d_hellinger"], _ = check_merge2d(
        merge_inputs(dev), h_sep, 128, True, 1,
        f"merge2d hellinger P={P_MAIN} N=512 K=128")
    wide = merge_inputs(dev, P=64, N=4096, seed=3)
    for metric in (0, 1):
        name = merge2d_variant(True, metric)
        err, _ = check_merge2d(wide, h_sep if metric else min_sep, 128, True,
                               metric, f"{name} P=64 N=4096 K=128")
        errs[name] = max(errs[name], err)
    err, _ = check_merge2d(
        full_grid_inputs(dev, N=512, seed=1, frac=0.6), h_sep, 128, False, 1,
        f"merge2d argmax hellinger P={P_MAIN} N=512 K=128")
    errs["merge2d_argmax_hellinger"] = max(errs["merge2d_argmax_hellinger"],
                                           err)
    # argmax mode, 16 slots: a NaN particle stalls and drops its lanes;
    # active zero-weight lanes never lead but count as left
    for metric in (0, 1):
        bad = full_grid_inputs(dev, P=64, N=512, seed=2, frac=0.6)
        bad[0, 0] = float("nan")
        bad[1:, 0, :64] = 0.0
        name = merge2d_variant(False, metric)
        err, got = check_merge2d(
            bad, HELL["min_separation"] if metric else min_sep, 16, False,
            metric, f"{name} overflow + NaN P=64 N=512 K=16")
        require(int(got[3][0]) == 0 and int(got[4][0]) == 0,
                f"{name}: NaN particle emitted clusters or kept lanes")
        require(bool((got[3][1:] == 16).all() and (got[4][1:] > 0).all()),
                f"{name} overflow: not every particle overflowed")
        errs[name] = max(errs[name], err)


def check_gathers(dev, errs):
    """Both gathers bit for bit against their twins at every case of
    gather_bench.GATHER_CASES, each launch counted under its mode's name
    (the slab staged in shared memory, or read through __ldg above
    build.GATHER_SMEM_BUDGET); both modes of each must run."""
    fns = {"cols": (gather_cols, gather_cols_reference),
           "rows": (gather_rows, gather_rows_reference)}
    modes = collections.Counter()
    for case, (kind, P, C, R, cap, opt) in GATHER_CASES.items():
        kern, twin = fns[kind]
        idx, tab = gather_case(dev, case)
        build.reset_launch_counts()
        got = kern(idx, tab)
        torch.cuda.synchronize()
        name = f"gather_{kind}" + (
            "" if build.gather_staged(C * R) else "_ldg")
        label = f"{name} {case} P={P} C={C} R={R} cap={cap} {opt or ''}"
        require(dict(build.launch_counts) == {name: 1},
                f"{label}: launched {dict(build.launch_counts)}")
        require(torch.equal(got, twin(idx, tab)),
                f"{label}: not bitwise equal")
        modes[name] += 1
        n_out = int(((idx < 0) | (idx >= R)).sum())
        phase("kernels", f"{label}: bitwise equal, {n_out} of "
              f"{idx.numel()} indices out of range gave zeros")
    for kind in fns:
        require(all(modes[f"gather_{kind}{m}"] for m in ("", "_ldg")),
                f"gather_{kind}: a mode never ran: {dict(modes)}")
    for name in modes:
        errs[name] = 0.0


def check_kernels(dev):
    """Each kernel against its twin at the main path's shapes."""
    errs = {}
    planes, z4 = detect_inputs(dev)
    cfg = load_config(CFG)
    min_fw, cb = cfg.min_feature_weight, cfg.clutter_density + cfg.birth_weight
    got = detect(planes, z4, 16, min_fw, cb)
    want = detect_reference(planes, z4, 16, min_fw, cb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    sel = want[0] > 0
    require(torch.equal(got[1][sel], want[1][sel]), "detect: idx differs")
    require(torch.equal(got[3], want[3]), "detect: live count differs")
    require(int(sel.sum()) > 0, "detect: no live lanes in the test input")
    errs["detect"] = max_err([(got[0], want[0]), (got[2], want[2])])
    phase("kernels", f"detect P={P_MAIN} K=128 M=48 T=16: {int(sel.sum())} "
          f"selected lanes, max |err| {errs['detect']:.3g} (rtol 1e-5)")

    check_gathers(dev, errs)

    planes = merge_inputs(dev)
    got = merge_out(merge2d(planes, cfg.min_separation, 128), 2)
    want = merge_out(merge2d_reference(planes, cfg.min_separation, 128), 2)
    require(torch.equal(got[3], want[3]), "merge2d: n_merged differs")
    require(torch.equal(got[4], want[4]), "merge2d: n_unmerged differs")
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    errs["merge2d"] = max_err(list(zip(got[:3], want[:3])))
    phase("kernels", f"merge2d P={P_MAIN} N=512 K=128: clusters/particle "
          f"{float(got[3].float().mean()):.1f}, max |err| "
          f"{errs['merge2d']:.3g} (rtol 1e-4, atol 1e-5)")

    nan_planes = merge_inputs(dev, P=64, seed=1)
    nan_planes[0, 0] = float("nan")
    nan_planes[1, 0, :8] = 0.0
    got = merge_out(merge2d(nan_planes, cfg.min_separation, 128), 2)
    torch.cuda.synchronize()
    want = merge_out(merge2d_reference(nan_planes, cfg.min_separation,
                                          128), 2)
    require(int(got[3][0]) == 0 and int(got[4][0]) == 0,
            "merge2d: NaN particle emitted clusters")
    require(torch.equal(got[3], want[3]) and torch.equal(got[4], want[4]),
            "merge2d: NaN case counts differ")
    phase("kernels", "merge2d NaN/zero weights: terminated, counts match")
    check_merge2d_variants(dev, errs, cfg.min_separation)

    # the mixed path's detect mode: min_fw = 0, cb = 0, M = 32
    planes, z4 = detect_inputs(dev, M=32, n_valid=24)
    got = detect(planes, z4, 16, 0.0, 0.0)
    want = detect_reference(planes, z4, 16, 0.0, 0.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    require(torch.equal(got[1], want[1]), "detect (min_fw=0): idx differs")
    require(torch.equal(got[3], want[3]),
            "detect (min_fw=0): live count differs")
    err0 = max_err([(got[0], want[0]), (got[2], want[2])])
    errs["detect"] = max(errs["detect"], err0)
    phase("kernels", f"detect P={P_MAIN} K=128 M=32 T=16 min_fw=0 cb=0: "
          f"{int(got[3].sum())} live lanes, idx and counts equal, max |err| "
          f"{err0:.3g} (rtol 1e-5)")

    errs["merge4d"] = 0.0
    for N in (128, 512):
        planes = merge4d_inputs(dev, N=N, seed=N)
        got = merge_out(merge4d(planes, 2.0, 128), 4)
        want = merge_out(merge4d_reference(planes, 2.0, 128), 4)
        require(torch.equal(got[3], want[3]), f"merge4d N={N}: n_merged "
                "differs")
        require(torch.equal(got[4], want[4]), f"merge4d N={N}: n_unmerged "
                "differs")
        for g, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        err = max_err(list(zip(got[:3], want[:3])))
        errs["merge4d"] = max(errs["merge4d"], err)
        phase("kernels", f"merge4d P={P_MAIN} N={N} K=128: clusters/particle "
              f"{float(got[3].float().mean()):.1f}, left "
              f"{float(got[4].float().mean()):.1f}, max |err| {err:.3g} "
              "(rtol 1e-4, atol 1e-5)")
    nan_planes = merge4d_inputs(dev, P=64, N=128, seed=1)
    nan_planes[0, 0] = float("nan")
    nan_planes[1, 0, :8] = 0.0
    got = merge_out(merge4d(nan_planes, 2.0, 128), 4)
    torch.cuda.synchronize()
    want = merge_out(merge4d_reference(nan_planes, 2.0, 128), 4)
    require(int(got[3][0]) == 0 and int(got[4][0]) == 0,
            "merge4d: NaN particle emitted clusters")
    require(torch.equal(got[3], want[3]) and torch.equal(got[4], want[4]),
            "merge4d: NaN case counts differ")
    phase("kernels", "merge4d NaN/zero weights: terminated, counts match")

    # the disparity path's merge: K=24 slots over the 512 compacted lanes
    errs["merge3d"] = 0.0
    for tag, K, centers in (("", 24, 16), (" overflow", 8, 16)):
        planes = merge3d_inputs(dev, n_centers=centers, seed=K)
        got_planes = merge3d(planes, 20.0, K)
        want = merge_out(merge3d_reference(planes, 20.0, K), 3)
        got = merge_out(got_planes, 3)
        require(bool((got_planes[:, 11] == 0).all()),
                "merge3d: pad plane not zero")
        require(torch.equal(got[3], want[3]), f"merge3d{tag}: n_merged "
                "differs")
        require(torch.equal(got[4], want[4]), f"merge3d{tag}: n_unmerged "
                "differs")
        for g, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        if tag:
            require(bool((got[3] == K).all() and (got[4] > 0).all()),
                    "merge3d overflow: not every particle overflowed")
        err = max_err(list(zip(got[:3], want[:3])))
        errs["merge3d"] = max(errs["merge3d"], err)
        phase("kernels", f"merge3d{tag} P={P_MAIN} N=512 K={K}: "
              f"clusters/particle {float(got[3].float().mean()):.1f}, left "
              f"{float(got[4].float().mean()):.1f}, max |err| {err:.3g} "
              "(rtol 1e-4, atol 1e-5)")
    nan_planes = merge3d_inputs(dev, P=64, seed=1)
    nan_planes[0, 0] = float("nan")
    nan_planes[1, 0, :8] = 0.0
    got = merge_out(merge3d(nan_planes, 20.0, 24), 3)
    torch.cuda.synchronize()
    want = merge_out(merge3d_reference(nan_planes, 20.0, 24), 3)
    require(int(got[3][0]) == 0 and int(got[4][0]) == 0,
            "merge3d: NaN particle emitted clusters")
    require(torch.equal(got[3], want[3]) and torch.equal(got[4], want[4]),
            "merge3d: NaN case counts differ")
    phase("kernels", "merge3d NaN/zero weights: terminated, counts match")
    # the 3D and 4D distances' quotient (merge_core.cuh::Recip) against
    # IEEE division: any finite floats, then magnitudes 2^-27 to 2^28
    for mode in (0, 1):
        r = recip_check(1 << 30, seed=mode, mode=mode, device=dev)
        require(r["tested"] > 0 and r["differ"] == 0
                and (mode == 0 or r["declined"] == 0),
                f"merge3d/merge4d quotient differs from IEEE division: {r}")
        phase("kernels", f"merge3d/merge4d quotient, mode {mode}: "
              f"{r['tested']} pairs, {r['declined']} left to IEEE "
              f"division, {r['differ']} differing from a / b")
    check_cardinality(dev, errs)
    return errs


def cardinality_inputs(dev, P=P_MAIN, C1=CPHD_C1, seed=0):
    """(log_cn [P, C1], log_cn_birth [C1]) for
    cardinality_predict_batch: random log cardinality distributions over
    many magnitudes and a random log birth distribution."""
    rng = np.random.default_rng(seed)
    log_cn = torch.from_numpy(
        rng.uniform(-60, 0, (P, C1)).astype(np.float32)).to(dev)
    log_b = torch.from_numpy(rng.uniform(-40, 0, C1).astype(np.float32)).to(
        dev)
    return log_cn, log_b


def toeplitz_operands(log_cn, log_b):
    """(lin [P, C1], T [C1, C1]) as the twin forms them from these inputs:
    the operands of the library call ``lin @ T``."""
    C1 = log_cn.shape[1]
    lin = torch.exp(log_cn - log_cn.amax(dim=-1, keepdim=True))
    ar = torch.arange(C1, device=log_cn.device)
    diff = ar[None, :] - ar[:, None]
    T = torch.where(diff >= 0,
                    torch.exp(log_b[diff.clamp_min(0)] - log_b.max()), 0.0)
    return lin, T


def cardinality_bound(log_cn, log_b):
    """cardinality_predict_batch's bound on these inputs: log_cn and
    log_cn_birth read once, the prediction written once; a multiply and an
    add for each term the rows need (a row with a finite max: the
    triangle n >= j, C1 (C1 + 1) / 2 terms; else C1 ** 2), and six more
    operations a row element (max, subtract, exp, log, two adds)."""
    P, C1 = log_cn.shape
    finite = int(torch.isfinite(log_cn.amax(dim=-1)).sum())
    terms = finite * C1 * (C1 + 1) // 2 + (P - finite) * C1 * C1
    return bound(4 * (2 * P * C1 + C1), 2 * terms + 6 * P * C1)


def check_cardinality(dev, errs):
    """cardinality_predict_batch's kernel against its twin at the CPHD
    path's shapes (P = 512 and 10240 rows, C1 = 65), both on the card: one
    launch, the same bits required, and the same bits for the rows taken
    as four blocks and one at a time (what makes a sharded CPHD step
    bit-equal); beside the CPU twin (PyTorch's CPU exp and log) and the
    float64 function within 60 nats of each row's peak, the largest
    distances reported."""
    errs["cardinality_predict"] = 0.0
    for P in (P_MAIN, P_SCALE):
        log_cn, log_b = cardinality_inputs(dev, P=P, seed=P)
        build.reset_launch_counts()
        got = cardinality_predict_batch(log_cn, log_b)
        torch.cuda.synchronize()
        require(dict(build.launch_counts) == {"cardinality_predict": 1},
                f"cardinality_predict P={P}: launched "
                f"{dict(build.launch_counts)}")
        want = cardinality_predict_reference(log_cn, log_b)
        require(same_bits([got], [want]),
                f"cardinality_predict P={P}: bits differ from the twin on "
                f"the card (max |diff| {max_err([(got, want)]):.3g})")
        blocks = torch.cat([cardinality_predict_batch(x, log_b)
                            for x in log_cn.split(P // 4)])
        rows = torch.cat([cardinality_predict_batch(log_cn[i:i + 1], log_b)
                          for i in range(0, P, P // 64)])
        require(same_bits([got], [blocks])
                and same_bits([got[::P // 64]], [rows]),
                f"cardinality_predict P={P}: a block's bits differ from "
                "the whole batch's")
        cpu = cardinality_predict_reference(log_cn.cpu(), log_b.cpu())
        x = log_cn.double()
        mx = x.amax(dim=-1, keepdim=True)
        b = log_b.double()
        ar = torch.arange(log_cn.shape[1], device=dev)
        diff = ar[None, :] - ar[:, None]
        T = torch.where(diff >= 0, torch.exp(b[diff.clamp_min(0)] - b.max()),
                        0.0)
        exact = torch.log(torch.exp(x - mx) @ T) + mx + b.max()
        near = exact > exact.amax(dim=-1, keepdim=True) - 60.0
        d_cpu = float((got.cpu().double() - cpu.double())[near.cpu()].abs()
                      .max())
        d_exact = float(((got.double() - exact)[near].abs()
                         / exact[near].abs().clamp_min(1.0)).max())
        phase("kernels", f"cardinality_predict P={P} C1={log_cn.shape[1]}: "
              f"one launch, bits equal to the twin on the card, 4 blocks "
              f"and {P // (P // 64)} single rows equal to the batch; within "
              f"60 nats of a row's peak max |diff| to the CPU twin "
              f"{d_cpu:.3g}, max relative distance to the float64 function "
              f"{d_exact:.3g}")


def far_persistent_scene(dev):
    """tests/test_consolidate.py's scene (its sensor settings): one feature
    at (5, 0) with covariance I, measured at (8, 0); the copy heads its
    column and the persistent copy is live but beyond min_separation 4."""
    cfg = load_config(CFG, dict(min_separation=4.0, std_range=0.25,
                                std_bearing=0.02, max_range=12.0,
                                clutter_rate=1.0, pd=0.9, birth_weight=0.01,
                                min_feature_weight=1e-5))
    P, K = 2, 8
    mean = torch.zeros((P, K, 2))
    mean[:, 0] = torch.tensor([5.0, 0.0])
    w = torch.zeros((P, K))
    w[:, 0] = 1.0
    s = Scene(torch.zeros((P, 6)), mean, torch.eye(2).expand(P, K, 2, 2),
              w, torch.tensor([[8.0, 0.0], [0.0, 0.0]]),
              torch.tensor([True, False]))
    return cfg, Scene(*(x.contiguous().to(dev) for x in s))


def check_variants(dev, errs):
    """The knob variants against their twins at the Ackerman and the dense
    shapes (:data:`VARIANT_SHAPES`, scenes of eval/scenes.py): adaptive
    trips bit-equal to the static kernel with trips running dry; the
    consolidating kernel, static and adaptive, with persistent heads and
    multi-member columns, and on the far-persistent scene; the fused gather
    + merge in both metrics against the two-kernel route on the card and
    against its twin, with equal counts. The plain detect at the dense
    shape too."""
    for shape, (path, P, K, M, n_valid, T) in VARIANT_SHAPES.items():
        cfg = load_config(path)
        s = map_scene(cfg, P, K, M, n_valid, seed=0, device=dev)
        min_fw = cfg.min_feature_weight
        cb = cfg.clutter_density + cfg.birth_weight
        planes, z4 = detect_planes(cfg, s)
        static = detect(planes, z4, T, min_fw, cb)
        adapt = detect(planes, z4, T, min_fw, cb, adaptive=True)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(adapt, static)),
                f"detect_adaptive {shape}: not bit-equal to the static trips")
        dry = int((adapt[3] < T).sum())
        require(dry > 0, f"detect_adaptive {shape}: no row ran dry")
        err, _ = compare_detect(adapt, detect_reference(planes, z4, T, min_fw,
                                                        cb), "detect_adaptive")
        errs["detect_adaptive"] = max(errs.get("detect_adaptive", 0.0), err)
        errs["detect"] = max(errs["detect"], err)
        phase("kernels", f"detect_adaptive {shape} P={P} K={K} M={M} T={T}: "
              f"bit-equal to the static kernel, {dry} of {adapt[3].numel()} "
              f"rows with fewer than T live lanes; against the twin max "
              f"|err| {err:.3g} (rtol 1e-5), idx and counts equal")

        planes13, _ = detect_planes(cfg, s, consolidate=True)
        for adaptive in (False, True):
            name = detect_variant(True, adaptive)
            args = (planes13, z4, T, min_fw, cb, cfg.min_separation)
            got = detect(*args, adaptive=adaptive)
            torch.cuda.synchronize()
            want = detect_reference(*args)
            err, flips = compare_detect(got, want, name, planes13, z4,
                                        min_fw, cb)
            errs[name] = max(errs.get(name, 0.0), err)
            c = want[4]
            heads = int(((c[:, 8] > 0) & (c[:, 6] == 0) & (c[:, 7] == 0))
                        .sum())
            far = int(((planes13[:, 6] > 0) & (c[:, 9] == 0)
                       & ((c[:, 6] != 0) | (c[:, 7] != 0))).sum())
            require(heads > 0 and far > 0 and bool((c[:, 8] > 1).any()),
                    f"{name} {shape}: the scene lacks a case")
            phase("kernels", f"{name} {shape} P={P} K={K} M={M} T={T}: "
                  f"{int(c[:, 8].sum())} members in {int((c[:, 8] > 0).sum())}"
                  f" columns ({int((c[:, 8] > 1).sum())} with several), "
                  f"{heads} persistent heads, {far} far-persistent columns "
                  f"kept; max |err| {err:.3g}, {flips} member flips at an f32 "
                  "boundary")

        g, ints, flts = tables_payload(cfg, s)
        for metric in (0, 1):
            name = merge2d_variant(True, metric, tables=True)
            min_sep = HELL["min_separation"] if metric else cfg.min_separation
            got = merge_out(merge2d_tables(ints, flts, g["t_k"], g["t_m"],
                                           min_sep, K, metric), 2)
            two = merge_out(merge2d(_finish_candidates_packed(g, 2), min_sep,
                                    K, metric=metric), 2)
            torch.cuda.synchronize()
            want = merge_out(merge2d_tables_reference(
                ints, flts, g["t_k"], g["t_m"], min_sep, K, metric), 2)
            for other, tag in ((two, "two-kernel route"), (want, "twin")):
                require(torch.equal(got[3], other[3])
                        and torch.equal(got[4], other[4]),
                        f"{name} {shape}: counts differ from the {tag}")
                for a, b in zip(got[:3], other[:3]):
                    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
            err = max_err(list(zip(got[:3], want[:3])))
            errs[name] = max(errs.get(name, 0.0), err)
            bitwise = all(torch.equal(a, b) for a, b in zip(got, two))
            phase("kernels", f"{name} {shape} P={P} N={ints.shape[-1]} K={K}:"
                  f" clusters/particle {float(got[3].float().mean()):.1f}, "
                  f"{'bit-equal to' if bitwise else 'within rtol 1e-4 of'} "
                  f"the two-kernel route on the card, max |err| vs twin "
                  f"{err:.3g} (rtol 1e-4, atol 1e-5), counts equal")

    cfg, s = far_persistent_scene(dev)
    planes13, z4 = detect_planes(cfg, s, consolidate=True)
    args = (planes13, z4, 4, cfg.min_feature_weight,
            cfg.clutter_density + cfg.birth_weight, cfg.min_separation)
    got = detect(*args)
    torch.cuda.synchronize()
    compare_detect(got, detect_reference(*args), "detect_cons far")
    require(bool((got[3][:, 0] == 1).all() and (got[4][:, 8:, 0] == 0).all()
                 and (got[4][:, 6, 0] > 2).all()),
            "detect_cons: the far persistent copy's column consolidated")
    phase("kernels", "detect_cons far-persistent scene: the copy heads, no "
          "member, pers_in 0, as the twin")
    check_detect_edges(dev, errs)
    check_merge_edges(dev, errs)


def check_detect_edges(dev, errs):
    """The detect kernel at the selection's edges (detect_bench.DETECT_EDGES:
    live count exactly T and T + 1, every lane dead, K 100, T = K, T 1,
    M 1, a NaN in a plane, duplicated features, K 1024 at min_fw 0), plain
    and consolidating, against the twin; adaptive bit-equal to static."""
    for case in DETECT_EDGES:
        for cons in (False, True):
            planes, z4, T, min_fw, cb = (
                torch.from_numpy(x).to(dev) if isinstance(x, np.ndarray)
                else x for x in detect_edge_case(case, cons))
            args = (planes, z4, T, min_fw, cb, MIN_SEP_EDGES if cons else 0.0)
            static = detect(*args)
            adapt = detect(*args, adaptive=True)
            torch.cuda.synchronize()
            name = detect_variant(cons)
            require(same_bits(adapt, static),
                    f"{name} edge {case}: adaptive differs from static")
            err, _ = compare_detect(static, detect_reference(*args),
                                    f"{name} edge {case}", planes, z4,
                                    min_fw, cb)
            for n in (name, detect_variant(cons, True)):
                errs[n] = max(errs.get(n, 0.0), err)
    phase("kernels", f"detect edges: {len(DETECT_EDGES)} cases, plain and "
          "consolidating, each static and adaptive (bit-equal), idx and "
          "counts equal to the twin's, values within rtol 1e-5")


def check_merge_edges(dev, errs):
    """The merge kernels at merge_bench.MERGE_EDGES (no lane entering,
    one lane, one all-covering cluster, K binding, NaN and w <= 0 weights,
    equal weights, N 2048 and 2049, N 8192 with every lane entering past
    the shared-memory slots, P 1, degenerate covariances at the 3D and 4D
    determinant clamps): merge2d in its four variants, merge2d_tables in
    both metrics, merge3d and merge4d up to their 2048 lanes, against
    their twins, counts equal."""
    runs = edge_runs(dev)
    for label, tabs, packed, K, sep, sorted_w, metric in runs:
        _, name, _, err = run_case(tabs, packed, K, sep, sorted_w, metric,
                                   label)
        errs[name] = max(errs.get(name, 0.0), err)
    phase("kernels", f"merge edges: {len(MERGE_EDGES)} cases, {len(runs)} "
          "runs (merge2d's four variants, merge2d_tables in both metrics, "
          "merge3d, merge4d): counts equal to the twins', values within "
          "rtol 1e-4, atol 1e-5")


def copy_state(state, dev):
    def gm_to(gm):
        return (None if gm is None else
                GMState(mean=gm.mean.to(dev), cov=gm.cov.to(dev),
                        weight=gm.weight.to(dev)))
    return FilterState(
        pose=state.pose.to(dev), log_weight=state.log_weight.to(dev),
        map_static=gm_to(state.map_static),
        resample_idx=state.resample_idx.to(dev), step=state.step,
        map_dynamic=gm_to(state.map_dynamic),
        cardinality=(None if state.cardinality is None
                     else state.cardinality.to(dev)),
        variance=(None if state.variance is None
                  else state.variance.to(dev)),
        prev_z=None if state.prev_z is None else state.prev_z.to(dev))


def step_against_cpu(r, n):
    """Step n of runner r on the card and, from a CPU copy of the same
    state with the same noise, with the twins on the CPU.

    The predicted and updated states (pose, log_weight, each map's weights
    and means, the CPHD cardinality) and the overflow are compared before
    resampling, where the kernels act; under shotgunning
    (n_predict_particles = k) both devices expand the P particles to P k
    first. Resampling is compared as nEff, the decision and the ancestors:
    a stratum may take another ancestor only where its point (j + u_j) / P
    lies within 1e-4 of a cumulative weight of the CPU state (f32 cumsums
    of 512 weights differ by ~1e-5 between the two devices). With
    compute_variance the CPU run draws the card's samples (a copy of the
    runner's second generator, drawn on the card again), and
    :func:`check_variance` holds the estimator. Returns the largest
    |difference| over the compared values (means in the slots that hold
    the same component), the CPU's updated state, the count of such
    boundary strata and the count of weight-tied slots swapped (see
    :func:`match_slots`).
    """
    z, zm, ctl, dt, dp, hz = r.step_args(n)
    gen = getattr(r, "var_generator", None)
    var_state = None if gen is None else gen.get_state()
    noise = r.noise()
    cpu_draw = None
    if var_state is not None:
        cpu_draw = replay_draws(var_state, r.device)
    runs = {"gpu": (r.state, z, zm, noise),
            "cpu": (copy_state(r.state, "cpu"), z.cpu(), zm.cpu(),
                    StepNoise(noise.eps_pred.cpu(), noise.u_resample.cpu(),
                              cpu_draw))}
    k = max(1, r.cfg.n_predict_particles)
    upd, ovf, res = {}, {}, {}
    estimators = {}
    for dev_name, (st, zz, mm, nz) in runs.items():
        P = st.pose.shape[0]
        if k > 1:
            st = expand_particles(st, k)
        if dp:
            st = predict(st, ctl, dt, r.cfg, nz.eps_pred)
        ovf[dev_name] = 0
        if hz:
            with recording_estimators(estimators.setdefault(dev_name, [])):
                st, ovf[dev_name] = update(st, zz, mm, r.cfg,
                                           var_draw=nz.var_draw)
        upd[dev_name] = st
        res[dev_name] = resample_particles(st, hz, r.cfg, nz.u_resample, P)
    g, c = upd["gpu"], upd["cpu"]
    pairs = {"pose": (g.pose, c.pose), "log_weight": (g.log_weight,
                                                      c.log_weight)}
    n_swapped, err = 0, 0.0
    for tag, attr in (("map", "map_static"), ("dyn", "map_dynamic")):
        if getattr(g, attr) is not None:
            gm, cm = getattr(g, attr), getattr(c, attr)
            pairs[f"{tag}_weight"] = (gm.weight, cm.weight)
            pairs[f"{tag}_mean"] = (gm.mean, cm.mean)
            n, e = match_slots(tag, gm.weight.cpu(), gm.mean.cpu(),
                               cm.weight, cm.mean)
            n_swapped, err = n_swapped + n, max(err, e)
    for name in ("pose", "log_weight", "map_weight", "dyn_weight"):
        if name in pairs:
            gv, cv = pairs[name]
            torch.testing.assert_close(gv.cpu(), cv, rtol=1e-4, atol=1e-5,
                                       msg=lambda m, n=name: f"{n}: {m}")
            err = max(err, max_err([(gv.cpu(), cv)]))
    if g.cardinality is not None:
        err = max(err, check_log_card(g.cardinality.cpu(), c.cardinality))
    require(int(ovf["gpu"]) == int(ovf["cpu"]), "step: overflow differs")

    n_edge = check_resampling(res["gpu"], res["cpu"], c.log_weight,
                              runs["cpu"][3].u_resample)
    if r.cfg.compute_variance and hz:
        check_variance(estimators["gpu"], replay_draws(var_state, r.device),
                       g.variance, c.variance)
    r.state = res["gpu"][0]
    return err, c, n_edge, n_swapped


def replay_draws(gen_state, device):
    """A variance-sample source that draws again, on the card, what a
    generator in ``gen_state`` drew, and hands it over on the CPU."""
    again = torch.Generator(device=device)
    again.set_state(gen_state)

    def draw(s, shape):
        return torch.randn(shape, generator=again, device=device).cpu()
    return draw


class recording_estimators:
    """Within the block, every call of the MC variance estimators
    (filters/phd.py's mc_variance_packed and mc_variance_candidates) is
    appended to ``calls`` as (function, arguments, result)."""

    NAMES = ("mc_variance_packed", "mc_variance_candidates")

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        self.real = {n: getattr(phd_filter, n) for n in self.NAMES}
        for n, fn in self.real.items():
            def rec(*a, fn=fn):
                out = fn(*a)
                self.calls.append((fn, a, out))
                return out
            setattr(phd_filter, n, rec)
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(phd_filter, n, fn)


def check_variance(gpu_calls, cpu_draw, g_var, c_var):
    """The MC variance of one step: the estimator's call on the card,
    evaluated again on the CPU on the same inputs (the card's planes) and
    the same draws, within rtol 1e-4 / atol 1e-5 of the card's result.
    The two devices' updates differ by f32 reassociation in the planes,
    which a thin covariance's determinant magnifies by its condition
    (c00 c11 / det, up to ~3e4 in these steps): the variances of the two
    updates are reported beside the largest such condition, not held."""
    require(len(gpu_calls) == 1, f"variance: {len(gpu_calls)} estimator "
            "calls in the update")
    fn, args, out = gpu_calls[0]
    *tensors, n_samples, _ = args
    want = fn(*(x.cpu() if torch.is_tensor(x) else x for x in tensors),
              n_samples, cpu_draw)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-5,
                               msg=lambda m: f"variance estimator: {m}")
    if fn.__name__ == "mc_variance_packed":
        planes = tensors[0]
        w, c00, c01, c11 = planes[:, 0], planes[:, 4], planes[:, 5], \
            planes[:, 6]
    else:
        w, cov = tensors[2], tensors[1]
        c00, c01, c11 = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    det = (c00.double() * c11 - c01.double() ** 2).clamp_min(1e-30)
    cond = float(torch.where(w > 0, c00.double() * c11 / det, 0.0).max())
    diff = (g_var.cpu().double() - c_var.double()).abs()
    far = int((diff > 1e-5 + 1e-4 * c_var.double().abs()).sum())
    phase("step", f"variance: the card's estimator on its planes = the "
          f"CPU's on them, max |err| {max_err([(out.cpu(), want)]):.3g} "
          f"(rtol 1e-4, atol 1e-5); the two updates' variances differ by "
          f"up to {float(diff.max()):.3g} ({far} of {diff.numel()} "
          f"particles beyond rtol 1e-4), largest live c00 c11 / det "
          f"{cond:.3g}")


def check_log_card(got, want):
    """Log cardinalities [P, C+1]: the entries within 60 nats of their
    row's peak within rtol 1e-4 / atol 1e-5; deeper ones (probability
    below 1e-26 of the peak, where f32 sums in another order can leave
    LOG0 on one side) only more than 50 nats below the peak on both.
    Returns the largest |difference| of the compared entries."""
    require(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
            "step: non-finite cardinality")
    peak = want.amax(dim=1, keepdim=True)
    near = want > peak - 60.0
    torch.testing.assert_close(got[near], want[near], rtol=1e-4, atol=1e-5,
                               msg=lambda m: f"cardinality: {m}")
    require(bool(((got - peak)[~near] < -50.0).all()),
            "step: cardinality tail differs")
    return max_err([(got[near], want[near])])


def check_resampling(gpu, cpu, log_weight, u):
    """nEff, the decision and the ancestors of (state, n_eff, resampled)
    on the card against the CPU: a stratum may take another ancestor only
    where its point (j + u_j) / P (P the strata, the particles resampled
    to) lies within 1e-4 of a cumulative weight of the CPU state
    ``log_weight``. Returns the count of such strata."""
    (g_st, g_neff, g_res), (c_st, c_neff, c_res) = gpu, cpu
    torch.testing.assert_close(g_neff.cpu(), c_neff, rtol=1e-4, atol=0)
    require(bool(g_res) == bool(c_res), "step: resampling decision differs")
    differ = (g_st.resample_idx.cpu() != c_st.resample_idx).nonzero()[:, 0]
    P = u.shape[0]
    cum = torch.cumsum(torch.exp(log_weight.double()), dim=0)
    for j in differ.tolist():
        point = (j + float(u[j])) / P
        require(float((cum - point).abs().min()) < 1e-4,
                f"step: stratum {j} took another ancestor away from a "
                "cumulative-weight boundary")
    return len(differ)


def match_slots(tag, g_w, g_mean, c_w, c_mean):
    """Means slot by slot within rtol 1e-4 / atol 1e-5, except that a slot
    may hold another component of the same particle where the two weights
    tie within that tolerance (the post-merge compaction sorts by weight,
    and two tied weights can round into either order). Returns the number
    of such swapped slots and the largest |difference| of the others."""
    ok = torch.isclose(g_mean, c_mean, rtol=1e-4, atol=1e-5).all(dim=-1)
    for p, k in (~ok).nonzero().tolist():
        tied = torch.isclose(c_w[p], g_w[p, k], rtol=1e-4, atol=1e-5)
        same = torch.isclose(c_mean[p], g_mean[p, k], rtol=1e-4,
                             atol=1e-5).all(dim=-1)
        require(bool((tied & same).any()),
                f"step: {tag}_mean of particle {p} slot {k} matches no "
                f"weight-tied component on the CPU (w {float(g_w[p, k])})")
    diff = (g_mean.double() - c_mean.double()).abs()[ok]
    return int((~ok).sum()), float(diff.max()) if diff.numel() else 0.0


def check_step(dev, n_before=40, overrides=None, cfg_path=CFG):
    """One Ackerman step on the card against the same step with the twins
    on the CPU, from step 40 and the same noise (:func:`step_against_cpu`),
    with the config ``overrides`` (a kernel knob, an estimator or a
    route; ``cfg_path``: the PHD or CPHD configuration). Returns the
    runner, at the state after the step."""
    cfg = load_config(cfg_path, dict(overrides or {}, n_particles=P_MAIN))
    r = SynthSLAMRunner(cfg, DATA, device=dev)
    for n in range(n_before):
        r.step(n)
    err, cpu_state, n_edge, n_swap = step_against_cpu(r, n_before)
    live = int((cpu_state.map_static.weight > 0).sum(dim=1).float().mean())
    var = ""
    if cfg.compute_variance:
        v = cpu_state.variance
        var = (f", variance {float(v.min()):.4g}..{float(v.max()):.4g} "
               "(card and CPU on the same draws)")
    phase("step", f"{cfg_path} step {n_before} at P={P_MAIN} "
          f"{overrides or ''} (mean {live} live components{var}): card vs "
          f"CPU twins max |err| {err:.3g} (rtol 1e-4, atol 1e-5), overflow "
          f"equal; {n_swap} weight-tied slots swapped, {n_edge} resampling "
          "strata at a cumulative-weight boundary")
    return r


def check_dense_steps(dev, n_before=40):
    """The dense configuration's step 40 on the card against the CPU twins
    for each variant (plain, fused + adaptive, consolidating + adaptive):
    the plain runner at P=1024 takes the first 40 steps on the card, then
    each variant steps every 16th particle of that state (64) on the card
    and on the CPU from the same noise (:func:`step_against_cpu`)."""
    base = SynthSLAMRunner(load_config(DENSE_CFG, {"n_particles": P_DENSE}),
                           DENSE_DATA, device=dev)
    for n in range(n_before):
        base.step(n)
    idx = torch.arange(0, P_DENSE, P_DENSE // P_DENSE_STEP, device=dev)
    gm = base.state.map_static
    sub = base.state.replace(
        pose=base.state.pose[idx], log_weight=base.state.log_weight[idx],
        map_static=GMState(mean=gm.mean[idx], cov=gm.cov[idx],
                           weight=gm.weight[idx]),
        resample_idx=base.state.resample_idx[idx])
    for label, over in DENSE_VARIANTS.items():
        r = SynthSLAMRunner(load_config(DENSE_CFG, dict(
            over, n_particles=P_DENSE_STEP)), DENSE_DATA, device=dev)
        r.state = sub
        err, cpu_state, n_edge, n_swap = step_against_cpu(r, n_before)
        live = float((cpu_state.map_static.weight > 0).sum(dim=1).float()
                     .mean())
        phase("step", f"dense step {n_before}, {label}, {P_DENSE_STEP} of "
              f"P={P_DENSE} (M={base.m_max}, mean {live:.1f} live "
              f"components): card vs CPU twins max |err| {err:.3g} (rtol "
              f"1e-4, atol 1e-5), overflow equal; {n_swap} weight-tied slots "
              f"swapped, {n_edge} resampling strata at a cumulative-weight "
              "boundary")


def check_mixed_step(dev, n_before=40):
    """One mixed step on the card against the same step with the twins on
    the CPU, from step 40 of the full-width configuration and the same
    noise (:func:`step_against_cpu`)."""
    r = mixed_runner(dev)
    for n in range(n_before):
        r.step(n)
    err, cpu_state, n_edge, n_swap = step_against_cpu(r, n_before)
    live_s = float((cpu_state.map_static.weight > 0).sum(dim=1).float()
                   .mean())
    live_d = float((cpu_state.map_dynamic.weight > 0).sum(dim=1).float()
                   .mean())
    phase("step", f"mixed step {n_before} at P={P_MAIN} (mean {live_s:.1f} "
          f"static, {live_d:.1f} dynamic live components): card vs CPU "
          f"twins max |err| {err:.3g} (rtol 1e-4, atol 1e-5), overflow "
          f"equal; {n_swap} weight-tied "
          f"slots swapped, {n_edge} resampling strata at a "
          "cumulative-weight boundary")


def check_cphd_step(dev, n_before=40):
    """One CPHD step on the card against the same step with the twins on
    the CPU, from step 40 of cfg/ackerman_cphd.cfg at P=512 and the same
    noise (:func:`step_against_cpu`, the cardinality included)."""
    cfg = load_config(CPHD_CFG, {"n_particles": P_MAIN})
    r = SynthSLAMRunner(cfg, DATA, device=dev)
    for n in range(n_before):
        r.step(n)
    err, cpu_state, n_edge, n_swap = step_against_cpu(r, n_before)
    live = int((cpu_state.map_static.weight > 0).sum(dim=1).float().mean())
    card = torch.exp(cpu_state.cardinality)
    mean_card = float((card * torch.arange(card.shape[1])).sum(dim=1).mean())
    phase("step", f"CPHD step {n_before} at P={P_MAIN} (mean {live} live "
          f"components, mean cardinality {mean_card:.2f}): card vs CPU "
          f"twins max |err| {err:.3g} (rtol 1e-4, atol 1e-5, cardinality "
          f"within 60 nats of its peak), overflow equal; {n_swap} "
          f"weight-tied slots swapped, {n_edge} resampling strata at a "
          "cumulative-weight boundary")


def disparity_runner(dev, P=P_MAIN, data=DISP_DATA, **overrides):
    cfg = load_config(DISP_CFG, dict(overrides, n_particles=P))
    return DisparityRunner(cfg, data, device=dev)


def feature_means_uvd(state, cam_pose, cfg):
    """Each feature cloud's mean in disparity space under cam_pose [P, 12],
    0 in empty slots: [P, K, 3]."""
    uvd = disp.world_to_disparity(state.cloud, cam_pose[:, None, None, :],
                                  cfg)
    return torch.where((state.feat_weight > 0)[..., None],
                       uvd.mean(dim=2), 0.0)


def check_disparity_step(dev, n_before=20):
    """One disparity step at P=512 on the card against the same step with
    the twins on the CPU, from step 20 of data/disparity and the same
    noise. Compared before resampling, where the kernel acts: camera
    poses, log weights, feature weights and each feature cloud's mean in
    disparity space under the CPU camera (rtol 1e-4 / atol 1e-5, slots of
    weight-tied features may swap, see :func:`match_slots`), and the
    overflow; then resampling as :func:`check_resampling`."""
    r = disparity_runner(dev)
    cfg = r.cfg
    for n in range(n_before):
        r.step(n)
    n = n_before
    noise = r.noise()
    require(bool(r.has_z[n]), "disparity step: no measurements at step 20")
    cpu_state = DisparityState(
        **{k: getattr(r.state, k).cpu() for k in (
            "cam_pose", "log_weight", "cloud", "feat_weight",
            "resample_idx")}, step=r.state.step)
    runs = {"gpu": (r.state, r.z_dev[n], r.mask_dev[n], noise),
            "cpu": (cpu_state, r.z_dev[n].cpu(), r.mask_dev[n].cpu(),
                    type(noise)(*(x.cpu() for x in noise)))}
    upd, ovf, res = {}, {}, {}
    for dev_name, (st, zz, mm, nz) in runs.items():
        st = disp.disparity_predict(st, cfg.dt, cfg, nz.eps_pred)
        st, ovf[dev_name] = disp.disparity_update(st, zz, mm, cfg,
                                                  nz.eps_sample)
        st = st.replace(log_weight=st.log_weight
                        - logsumexp(st.log_weight, dim=0))
        upd[dev_name] = st
        res[dev_name] = disp._resample(st, cfg, nz.u_resample)
    g, c = upd["gpu"], upd["cpu"]
    err = 0.0
    for name in ("cam_pose", "log_weight", "feat_weight"):
        gv, cv = getattr(g, name).cpu(), getattr(c, name)
        torch.testing.assert_close(gv, cv, rtol=1e-4, atol=1e-5,
                                   msg=lambda m, n=name: f"{n}: {m}")
        err = max(err, max_err([(gv, cv)]))
    n_swap, e = match_slots("feature", g.feat_weight.cpu(),
                            feature_means_uvd(g, c.cam_pose.to(dev), cfg)
                            .cpu(), c.feat_weight,
                            feature_means_uvd(c, c.cam_pose, cfg))
    err = max(err, e)
    require(int(ovf["gpu"]) == int(ovf["cpu"]),
            "disparity step: overflow differs")
    n_edge = check_resampling(res["gpu"], res["cpu"], c.log_weight,
                              noise.u_resample.cpu())
    live = float((c.feat_weight > 0).sum(dim=1).float().mean())
    phase("step", f"disparity step {n} at P={P_MAIN} (mean {live:.1f} live "
          f"features of {cfg.max_features}): card vs CPU twins max |err| "
          f"{err:.3g} (rtol 1e-4, atol 1e-5), overflow equal "
          f"({int(ovf['cpu'])}); {n_swap} weight-tied slots swapped, "
          f"{n_edge} resampling strata at a cumulative-weight boundary")


def run_disparity_data(dev):
    """data/disparity at P=512, all 80 frames: steps/s (host clock), the
    mean camera-position error against groundtruth.npz ``traj``, OSPA(1,
    1 m) of the MAP particle's map against its ``landmarks``, and the
    merge3d launches (one per step with measurements)."""
    r = disparity_runner(dev)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = clean(r.run(), "disparity")
    counts = dict(build.launch_counts)
    gt = np.load(f"{DISP_DATA}/groundtruth.npz")
    est = res["est_poses"]
    require(np.isfinite(est).all(), "disparity: NaN in the poses")
    err = np.linalg.norm(est[:, :3] - gt["traj"][:len(est), :3], axis=1)
    est_map = disparity_map_estimate(r.state)
    o, _, _ = ospa_distance(gt["landmarks"], est_map, p=1, c=1.0)
    phase("disparity", f"data/disparity P={P_MAIN}, {len(est)} frames: "
          f"{res['steps_per_s']:.2f} steps/s ({res['wall_s']:.3f} s), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
          f"mean pose error {err.mean():.4f} m (final {err[-1]:.4f}), "
          f"OSPA(1, 1 m) {o:.4f} with {len(est_map)} of "
          f"{len(gt['landmarks'])} landmarks, overflow {res['overflow']}")
    phase("disparity", "launches: " + ", ".join(
        f"{k}={counts.get(k, 0)}" for k in KERNELS))
    n_z = int(r.has_z.sum())
    require(counts.get("merge3d", 0) == n_z > 0,
            f"merge3d launched {counts.get('merge3d', 0)} times, steps "
            f"with measurements {n_z}")
    return counts


def disparity_one_point(dev, P=64, frames=10):
    """particles_per_feature 1 (clouds of one point: the sample covariance
    divides by N - 1 = 0, NaN, as in the JAX package) over the first
    frames of data/disparity on the card and on the CPU: both runs end,
    merge3d launched on the card over the NaN lanes, and the runner
    reports the same first NaN step on both."""
    out = {}
    for where in (dev, torch.device("cpu")):
        cfg = load_config(DISP_CFG, {"n_particles": P, "n_steps": frames,
                                     "particles_per_feature": 1})
        build.reset_launch_counts()
        out[where.type] = (DisparityRunner(cfg, DISP_DATA,
                                           device=where).run(),
                           dict(build.launch_counts))
    (g, counts), (c, _) = out["cuda"], out["cpu"]
    require(g["nan_step"] is not None and g["nan_step"] == c["nan_step"],
            f"disparity one-point: first NaN step {g['nan_step']} on the "
            f"card, {c['nan_step']} on the CPU")
    require(counts.get("merge3d", 0) > 0,
            "disparity one-point: merge3d never launched")
    phase("disparity one-point", f"P={P}, {frames} frames: NaN weights "
          f"reported from step {g['nan_step']} on the card and on the CPU, "
          f"merge3d {counts['merge3d']} launches, both runs ended")


def disparity_bench(dev):
    """The JAX package's disparity bench rows (``bench.py::_disparity_row``):
    a generated world (seed 0, 24 landmarks, 60 frames) at P=200 and
    P=512; one warm run, then two runs with seeds 1000 and 1001."""
    cfg0 = load_config(DISP_CFG)
    _, _, ms = simdata.generate_disparity_world(
        n_landmarks=24, n_steps=DISP_BENCH_STEPS, dt=cfg0.dt, seed=0,
        fx=cfg0.fx, fy=cfg0.fy, u0=cfg0.u0, v0=cfg0.v0,
        width=int(cfg0.image_width), height=int(cfg0.image_height),
        std_uv=cfg0.std_u, pd=cfg0.pd, clutter_rate=cfg0.clutter_rate,
        vx=cfg0.vx0)
    with tempfile.TemporaryDirectory(prefix="disparity_bench_") as tmp:
        simdata.write_disparity_run_dir(tmp, ms)
        for P in DISP_BENCH_P:
            clean(disparity_runner(dev, P, tmp,
                                   n_steps=DISP_BENCH_STEPS).run(),
                  f"disparity bench P={P}")
            rates = []
            for rep in range(2):
                res = clean(disparity_runner(
                    dev, P, tmp, n_steps=DISP_BENCH_STEPS,
                    seed=1000 + rep).run(), f"disparity bench P={P}")
                require(np.isfinite(res["est_poses"]).all(),
                        f"disparity bench: NaN at P={P}")
                rates.append(res["steps_per_s"])
            phase("disparity", f"bench P={P}, {DISP_BENCH_STEPS} frames: "
                  f"{max(rates):.2f} steps/s (runs "
                  f"{', '.join(f'{v:.2f}' for v in rates)})")


def disparity_accuracy(dev):
    """Full-SLAM ``evaluate_disparity`` at P=512 over seeds 0-4 (25
    landmarks, 60 frames) against the JAX package's mean +- 2 std, and
    known-pose mapping at seed 0 within tests/test_disparity.py's bounds."""
    rows = []
    for seed in DISP_SEEDS:
        r = evaluate_disparity(seed=seed, follow_trajectory=False,
                               cfg_overrides={"n_particles": P_DISP_ACC},
                               device=dev)
        clean(r["run"], f"disparity accuracy seed {seed}")
        require(np.isfinite(r["pose_err"]).all() and np.isfinite(r["ospa"]),
                f"disparity accuracy: NaN in seed {seed}")
        rows.append([r[k] for k in DISP_BANDS])
        phase("accuracy", f"disparity seed {seed}: pose "
              f"{r['mean_pose_err']:.4f} m (final {r['final_pose_err']:.4f}),"
              f" OSPA(1, 1 m) {r['ospa']:.4f}, {r['n_est']} of {r['n_true']} "
              f"landmarks, {r['steps_per_s']:.2f} steps/s")
    rows = np.asarray(rows)
    for i, (k, (ref, ref_std)) in enumerate(DISP_BANDS.items()):
        mean, std = float(rows[:, i].mean()), float(rows[:, i].std())
        lo, hi = ref - 2 * ref_std, ref + 2 * ref_std
        phase("accuracy", f"disparity {k} over seeds {list(DISP_SEEDS)} at "
              f"P={P_DISP_ACC}: {mean:.4f} +- {std:.4f}, "
              f"{'inside' if lo <= mean <= hi else 'outside'} the JAX band "
              f"{ref} +- 2 x {ref_std}")
    pose = float(rows[:, 0].mean())
    require(pose <= ATE_LIMIT, f"disparity mean pose error {pose:.4f} m > "
            f"{ATE_LIMIT} m")
    r = evaluate_disparity(seed=0, device=dev)
    clean(r["run"], "disparity known-pose seed 0")
    phase("accuracy", f"disparity known-pose seed 0: OSPA(1, 1 m) "
          f"{r['ospa']:.4f} (JAX {DISP_KNOWN_POSE_OSPA}), {r['n_est']} of "
          f"{r['n_true']} landmarks")
    require(abs(r["n_est"] - r["n_true"]) <= 4 and r["ospa"] < 0.97,
            f"disparity known-pose mapping outside |n_est - n_true| <= 4, "
            f"OSPA < 0.97: {r['n_est']}/{r['n_true']}, {r['ospa']:.4f}")


def run_main(dev):
    build.reset_launch_counts()
    res = evaluate_dataset(CFG, ".", overrides={"n_particles": P_MAIN},
                           device=dev)
    counts = dict(build.launch_counts)
    run = clean(res["run"], "run")
    ate = res["mean_pose_err"]
    phase("run", f"data/ackerman P={P_MAIN}, {len(run['n_eff'])} steps: "
          f"{res['steps_per_s']:.2f} steps/s ({run['wall_s']:.3f} s), "
          f"mean ATE {ate:.4f} m, max {res['max_pose_err']:.4f} m, "
          f"mean OSPA(1, 5) {res['mean_ospa']:.4f} (final "
          f"{res['final_ospa']:.4f}), overflow {run['overflow']}")
    phase("run", "launches: " + ", ".join(f"{k}={counts.get(k, 0)}"
                                          for k in KERNELS))
    lo, hi = ATE_BAND
    phase("run", f"ATE {'inside' if lo <= ate <= hi else 'outside'} the "
          f"reference band {lo}-{hi} m")
    require(all(counts.get(k, 0) > 0 for k in ACKERMAN_KERNELS),
            f"a kernel of the path never launched: {counts}")
    require(np.isfinite(run["est_poses"]).all(), "NaN in the poses")
    require(ate <= ATE_LIMIT, f"mean ATE {ate:.4f} m > {ATE_LIMIT} m")
    return counts, res


def run_path(dev, label, cfg_path, overrides, kernels, n_steps=None,
             P=P_MAIN):
    """``evaluate_dataset`` at P particles (512 by default) with the launch
    counts set to 0 just before and read just after: steps/s, peak memory,
    mean ATE, mean every-step OSPA(1, 5), overflow and launches. Requires
    finite poses and weights (the runner reports the first NaN step after
    the run) and every kernel variant in ``kernels`` launched. Returns
    (counts, res)."""
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = evaluate_dataset(cfg_path, ".", n_steps=n_steps,
                           overrides=dict(overrides, n_particles=P),
                           device=dev)
    counts = dict(build.launch_counts)
    run = res["run"]
    require(np.isfinite(run["est_poses"]).all()
            and np.isfinite(run["n_eff"]).all(), f"{label}: NaN")
    phase(label, f"{cfg_path} {overrides} P={P} M={run['m_max']}, "
          f"{len(run['n_eff'])} "
          f"steps: {res['steps_per_s']:.2f} steps/s ({run['wall_s']:.3f} s),"
          f" peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
          f"MiB, mean ATE {res['mean_pose_err']:.4f} m, max "
          f"{res['max_pose_err']:.4f} m, mean OSPA(1, 5) "
          f"{res['mean_ospa']:.4f} (final {res['final_ospa']:.4f}), overflow "
          f"{run['overflow']}")
    phase(label, "launches: " + ", ".join(f"{k}={counts.get(k, 0)}"
                                          for k in KERNELS))
    require(all(counts.get(k, 0) > 0 for k in kernels),
            f"{label}: a kernel of the path never launched: {counts}")
    return counts, res


def run_cphd(dev):
    """cfg/ackerman_cphd.cfg at P=512 over the full dataset (against the
    JAX package's CPU band, fail above 1.0 m), then the first 60 steps at
    P=10240. Returns the P=512 run's (counts, res)."""
    counts, res = run_path(dev, "cphd", CPHD_CFG, {}, CPHD_KERNELS)
    for key, val in (("ate", res["mean_pose_err"]),
                     ("ospa", res["mean_ospa"])):
        ref, std = CPHD_BAND[key]
        lo, hi = ref - 2 * std, ref + 2 * std
        phase("cphd", f"mean {key} {val:.4f} "
              f"{'inside' if lo <= val <= hi else 'outside'} the JAX CPU "
              f"band {ref} +- 2 x {std} (seeds 0-2 at P={P_MAIN})")
    require(res["mean_pose_err"] <= ATE_LIMIT,
            f"CPHD mean ATE {res['mean_pose_err']:.4f} m > {ATE_LIMIT} m")
    cfg = load_config(CPHD_CFG, {"n_particles": P_SCALE,
                                 "n_steps": SCALE_STEPS})
    torch.cuda.reset_peak_memory_stats()
    scale = clean(SynthSLAMRunner(cfg, DATA, device=dev).run(),
                  f"CPHD P={P_SCALE}")
    require(np.isfinite(scale["est_poses"]).all(), f"CPHD NaN at P={P_SCALE}")
    phase("cphd", f"P={P_SCALE}, first {SCALE_STEPS} steps: "
          f"{scale['steps_per_s']:.2f} steps/s ({scale['wall_s']:.3f} s), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return counts, res


def run_full_grid(dev, capped):
    """The uncapped route (merge_candidate_cap 0: every lane through the
    argmax merge) of the PHD and CPHD configurations at P=512, each beside
    its capped run's ATE (``capped``: config -> mean ATE). The PHD run
    fails above 1.0 m. Returns the PHD run's launch counts and the CPHD
    run's result."""
    steps = f"{FULL_GRID_STEPS} steps" if FULL_GRID_STEPS else "all steps"
    out = {}
    for cfg_path in (CFG, CPHD_CFG):
        counts, res = run_path(dev, "full-grid", cfg_path,
                               {"merge_candidate_cap": 0}, FULL_GRID_KERNELS,
                               n_steps=FULL_GRID_STEPS)
        ate = res["mean_pose_err"]
        phase("full-grid", f"{cfg_path} ({steps}): mean ATE {ate:.4f} m "
              f"beside the capped run's {capped[cfg_path]:.4f} m (full "
              "dataset)")
        out[cfg_path] = counts, res
    ate = out[CFG][1]["mean_pose_err"]
    require(ate <= ATE_LIMIT, f"full-grid PHD mean ATE {ate:.4f} m > "
            f"{ATE_LIMIT} m")
    return out[CFG][0], out[CPHD_CFG][1]


def cphd_route_seeds(dev, seed0):
    """Both CPHD routes at P=512 over the full dataset (the det route at
    the config's cap, and the full grid, cap 0) at seeds 1-3, beside the
    runs of seed 0 (``seed0``: route -> evaluate_dataset's result): each
    run's mean ATE and OSPA, then each route's mean and std over seeds 0-3
    against that route's JAX CPU band and the mean of the per-seed gaps
    (full grid minus det route). Every run must stay finite."""
    routes = {"det": {}, "full grid": {"merge_candidate_cap": 0}}
    bands = {"det": CPHD_BAND, "full grid": CPHD_FULL_BAND}
    rows = {route: [(seed0[route]["mean_pose_err"], seed0[route]["mean_ospa"])]
            for route in routes}
    for seed in CPHD_SEEDS:
        for route, over in routes.items():
            res = evaluate_dataset(CPHD_CFG, ".", overrides=dict(
                over, n_particles=P_MAIN, seed=seed), device=dev)
            require(np.isfinite(res["run"]["est_poses"]).all()
                    and np.isfinite(res["run"]["n_eff"]).all(),
                    f"CPHD {route} seed {seed}: NaN")
            rows[route].append((res["mean_pose_err"], res["mean_ospa"]))
            phase("cphd-seeds", f"{route} seed {seed}: mean ATE "
                  f"{res['mean_pose_err']:.4f} m, mean OSPA(1, 5) "
                  f"{res['mean_ospa']:.4f}, {res['steps_per_s']:.2f} steps/s")
    seeds = [0, *CPHD_SEEDS]
    for route, vals in rows.items():
        v = np.asarray(vals)
        for i, key in enumerate(("ate", "ospa")):
            ref, std = bands[route][key]
            mean = float(v[:, i].mean())
            inside = ref - 2 * std <= mean <= ref + 2 * std
            phase("cphd-seeds", f"{route} mean {key} over seeds {seeds} at "
                  f"P={P_MAIN}: {mean:.4f} +- {v[:, i].std():.4f}, "
                  f"{'inside' if inside else 'outside'} the JAX CPU band "
                  f"{ref} +- 2 x {std} (seeds 0-2)")
    gap = np.asarray(rows["full grid"]) - np.asarray(rows["det"])
    phase("cphd-seeds", f"full grid minus det route, per seed: ATE "
          f"{', '.join(f'{g:+.4f}' for g in gap[:, 0])} m (mean "
          f"{gap[:, 0].mean():+.4f}), OSPA "
          f"{', '.join(f'{g:+.4f}' for g in gap[:, 1])}")


def run_hellinger(dev):
    """cfg/ackerman.cfg with the Hellinger merge distance (min_separation
    0.6, the JAX Hellinger test's value): 100 steps on the det route, 30 on
    the full grid, then 100 on the det route with the fused gather + merge
    (merge2d_tables_hellinger); all must stay finite. Returns the three
    runs' launch counts."""
    counts, _ = run_path(dev, "hellinger", CFG, HELL, HELL_KERNELS,
                         n_steps=HELL_STEPS)
    counts_full, _ = run_path(dev, "hellinger", CFG,
                              dict(HELL, merge_candidate_cap=0),
                              HELL_FULL_KERNELS, n_steps=HELL_FULL_STEPS)
    counts_fused, _ = run_path(dev, "hellinger", CFG,
                               dict(HELL, fused_gather_merge=1),
                               HELL_FUSED_KERNELS, n_steps=HELL_STEPS)
    return counts, counts_full, counts_fused


def run_knobs(dev, plain):
    """data/ackerman at P=512 over the whole dataset with fused_gather_merge
    + detect_adaptive, which must reproduce the plain run's (``plain``,
    evaluate_dataset's result) mean ATE within 1e-3 m, and with
    premerge_consolidate, reported beside the plain run (fail on NaN or
    ATE > 1.0 m). Returns both runs' launch counts."""
    knob_counts, res = run_path(dev, "knobs", CFG, FUSED_ADAPTIVE,
                                KNOB_KERNELS)
    diff = abs(res["mean_pose_err"] - plain["mean_pose_err"])
    same = np.array_equal(res["run"]["est_poses"], plain["run"]["est_poses"])
    phase("knobs", f"fused + adaptive: mean ATE {res['mean_pose_err']:.4f} "
          f"m vs the plain run's {plain['mean_pose_err']:.4f} (|diff| "
          f"{diff:.3g}, gate {ATE_REPRO}); every pose "
          f"{'identical to' if same else 'not identical to'} the plain run's")
    require(diff <= ATE_REPRO, f"fused + adaptive ATE moved by {diff:.3g} m")
    cons_counts, res = run_path(dev, "knobs", CFG, CONS, CONS_KERNELS)
    phase("knobs", f"consolidation: mean ATE {res['mean_pose_err']:.4f} m, "
          f"OSPA {res['mean_ospa']:.4f} beside the plain "
          f"{plain['mean_pose_err']:.4f} m, {plain['mean_ospa']:.4f} (no "
          "band: consolidation moves Ackerman accuracy)")
    require(res["mean_pose_err"] <= ATE_LIMIT,
            f"consolidation: mean ATE {res['mean_pose_err']:.4f} m > "
            f"{ATE_LIMIT} m")
    return knob_counts, cons_counts


def run_dense(dev):
    """cfg/dense.cfg on data/dense (200 steps) at P=1024 plain, fused +
    adaptive and consolidating + adaptive, each against the JAX package's
    dense band (fail on NaN or ATE > 1.0 m); then fused + adaptive at
    P=10240, its peak memory, its ATE and OSPA beside the JAX package's
    P=10240 row, and a second run that must repeat every pose bit for bit
    (:func:`audit_dense_scale` locates what would not). Returns each
    P=1024 variant's launch counts."""
    out = {}
    for label, over in DENSE_VARIANTS.items():
        counts, res = run_path(dev, "dense", DENSE_CFG, over,
                               DENSE_KERNELS[label], P=P_DENSE)
        for key, val in (("ate", res["mean_pose_err"]),
                         ("ospa", res["mean_ospa"])):
            lo, hi = DENSE_BAND[key]
            phase("dense", f"{label} P={P_DENSE}: mean {key} {val:.4f} "
                  f"{'inside' if lo <= val <= hi else 'outside'} the JAX "
                  f"band {lo}-{hi}")
        require(res["mean_pose_err"] <= ATE_LIMIT,
                f"dense {label}: mean ATE {res['mean_pose_err']:.4f} m > "
                f"{ATE_LIMIT} m")
        out[label] = counts
    runs = []
    for _ in range(2):
        counts, res = run_path(dev, "dense", DENSE_CFG, FUSED_ADAPTIVE,
                               KNOB_KERNELS, P=P_DENSE_SCALE)
        phase("dense", f"fused + adaptive P={P_DENSE_SCALE}: mean ATE "
              f"{res['mean_pose_err']:.4f} m, OSPA {res['mean_ospa']:.4f} "
              f"beside the JAX package's {DENSE_SCALE_REF['ate']} m, "
              f"{DENSE_SCALE_REF['ospa']}")
        require(res["mean_pose_err"] <= ATE_LIMIT,
                f"dense P={P_DENSE_SCALE}: mean ATE "
                f"{res['mean_pose_err']:.4f} m > {ATE_LIMIT} m")
        runs.append(res["est_poses"])
    differ = np.nonzero((runs[0] != runs[1]).any(axis=1))[0]
    phase("dense", f"P={P_DENSE_SCALE} twice: "
          + ("every pose bit-equal" if not len(differ) else
             f"poses differ from measurement step {differ[0]} on"))
    require(not len(differ), f"dense P={P_DENSE_SCALE}: a second run does "
            "not repeat the first")
    return out


def same_bits(a, b):
    """Tensors, or dicts, tuples, lists and dataclasses of them, equal bit
    for bit (a NaN equals the same NaN); anything else equal."""
    if dataclasses.is_dataclass(a):
        return all(same_bits(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_bits, a, b))
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and torch.equal(a, b)
    return a == b


def memory_at_peak(fn, top=8):
    """Run fn once under the CUDA allocator's history and return (peak
    bytes allocated during fn above what was live before it, the ``top``
    largest allocations live at that peak as (bytes, innermost frame of
    this repo's code))."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=500000,
                                             stacks="python")
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] in ("free_requested", "free_completed"):
            gone = live.pop(ev["addr"], None)
            total -= gone["size"] if gone else 0

    def site(ev):
        for fr in ev.get("frames", []):
            if "phdslam_tpu_torch" in fr["filename"]:
                path = fr["filename"].split("phdslam_tpu_torch", 1)[1]
                return f"phdslam_tpu_torch{path}:{fr['line']} {fr['name']}"
        return "(outside phdslam_tpu_torch)"
    big = sorted(at_peak.values(), key=lambda e: -e["size"])[:top]
    return peak, [(e["size"], site(e)) for e in big]


def audit_dense_scale(dev, n_before=40):
    """What the P=10240 dense run (fused + adaptive) repeats and what it
    holds: from the state after ``n_before`` steps, each stage of one step
    (predict, the update's pre half with detect_adaptive, merge2d_tables,
    the post half, resampling) runs twice from the same inputs and must
    give the same bits; its peak memory above its inputs is printed, and
    the largest allocations live at the whole step's peak with the line
    that made them. Then the whole P=10240 run twice with the resampling's
    scan as it was before, a 1D torch.cumsum, whose f32 rounding depends on
    the order in which its tiles finish: reported, not gated (whether the
    two runs part depends on the timing of the call)."""
    cfg = load_config(DENSE_CFG, dict(FUSED_ADAPTIVE,
                                      n_particles=P_DENSE_SCALE))
    r = SynthSLAMRunner(cfg, DENSE_DATA, device=dev)
    for n in range(n_before):
        r.step(n)
    z, zm, ctl, dt, do_pred, has_z = r.step_args(n_before)
    require(do_pred and has_z, "dense audit: the step lacks a stage")
    noise = r.noise()
    st = r.state
    K = cfg.max_components
    stages = {}

    def stage(label, fn):
        outs = []
        for _ in range(2):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs.append(fn())
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        same = same_bits(*outs)
        stages[label] = same
        phase("dense", f"audit P={P_DENSE_SCALE} step {n_before} {label}: "
              f"{'bit-equal' if same else 'DIFFERS'} on a second call, peak "
              f"{peak / 2**20:.0f} MiB above its inputs")
        return outs[0]

    st_p = stage("predict", lambda: predict(st, ctl, dt, cfg,
                                            noise.eps_pred))
    gm = st_p.map_static
    pre = stage("pre (detect_adaptive)", lambda: _update_pre(
        st_p.pose, gm.mean, gm.cov, gm.weight, z, zm, cfg))
    mg = stage("merge2d_tables", lambda: gather_merge(
        pre["gather"], 2, cfg, K, fused=True))
    post = stage("post", lambda: _post_compact_batched(
        mg, pre, gm.mean, gm.cov, gm.weight, cfg))
    log_w = st_p.log_weight + post[3]
    st_u = st_p.replace(
        map_static=GMState(mean=post[0], cov=post[1], weight=post[2]),
        log_weight=log_w - logsumexp(log_w, dim=0))
    stage("resample", lambda: maybe_resample(st_u, True, cfg,
                                             noise.u_resample))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peak, big = memory_at_peak(lambda: r.step(n_before))
    phase("dense", f"audit P={P_DENSE_SCALE} step {n_before}: peak "
          f"{peak / 2**20:.0f} MiB above the {base / 2**20:.0f} MiB live "
          "before it; largest at the peak: " + "; ".join(
              f"{b / 2**20:.0f} MiB {s}" for b, s in big))
    require(all(stages.values()), f"dense audit: a stage does not repeat "
            f"itself: {stages}")

    # the resampling with the 1D torch.cumsum it took before: the same
    # 200 steps twice, reported beside run_dense's fixed-order pair
    plain_scan = mock.patch.object(resample, "cumsum_fixed_order",
                                   lambda x: torch.cumsum(x, dim=0))
    runs = []
    with plain_scan:
        for _ in range(2):
            runs.append(evaluate_dataset(DENSE_CFG, ".", overrides=dict(
                FUSED_ADAPTIVE, n_particles=P_DENSE_SCALE), device=dev))
            clean(runs[-1]["run"], f"dense P={P_DENSE_SCALE} 1D scan")
    differ = np.nonzero((runs[0]["est_poses"] != runs[1]["est_poses"])
                        .any(axis=1))[0]
    phase("dense", f"P={P_DENSE_SCALE} twice with a 1D torch.cumsum in the "
          "resampling: mean ATE " + ", ".join(
              f"{r['mean_pose_err']:.4f}" for r in runs) + " m; "
          + ("every pose bit-equal" if not len(differ) else
             f"poses differ from measurement step {differ[0]} on"))


def dense_seeds(dev):
    """A second witness for the dense band: the port at the particle counts
    and seeds of the JAX package's CPU runs (:data:`DENSE_CPU_SEEDS`), each
    seed's ATE and OSPA, then per metric both packages' mean and std over
    the seeds and the difference of the means with its standard error
    (each package draws its own noise, so only the distributions compare).
    Fail on NaN; no ATE bound, since at P=64 single draws of either
    package pass 1 m."""
    for P, jax_rows in DENSE_CPU_SEEDS.items():
        rows = []
        for seed in range(len(jax_rows)):
            res = evaluate_dataset(DENSE_CFG, ".", overrides={
                "n_particles": P, "seed": seed}, device=dev)
            require(np.isfinite(res["run"]["est_poses"]).all(),
                    f"dense P={P} seed {seed}: NaN")
            clean(res["run"], f"dense P={P} seed {seed}")
            rows.append((res["mean_pose_err"], res["mean_ospa"]))
            phase("dense", f"P={P} seed {seed}: mean ATE "
                  f"{res['mean_pose_err']:.4f} m, OSPA "
                  f"{res['mean_ospa']:.4f}")
        for i, key in enumerate(("ate", "ospa")):
            port = np.asarray(rows)[:, i]
            ref = np.asarray(jax_rows)[:, i]
            diff = float(port.mean() - ref.mean())
            se = float(np.sqrt(port.var(ddof=1) / len(port)
                               + ref.var(ddof=1) / len(ref)))
            phase("dense", f"P={P} seeds 0-{len(rows) - 1}: {key} port "
                  f"{port.mean():.4f} +- {port.std():.4f}, JAX CPU "
                  f"{ref.mean():.4f} +- {ref.std():.4f}; port - JAX "
                  f"{diff:+.4f}, standard error {se:.4f} "
                  f"({'within' if abs(diff) <= 2 * se else 'beyond'} 2)")


def run_scale(dev):
    cfg = load_config(CFG, {"n_particles": P_SCALE, "n_steps": SCALE_STEPS})
    r = SynthSLAMRunner(cfg, DATA, device=dev)
    res = clean(r.run(), f"scale P={P_SCALE}")
    require(np.isfinite(res["est_poses"]).all(), f"NaN at P={P_SCALE}")
    phase("scale", f"P={P_SCALE}, first {SCALE_STEPS} steps: "
          f"{res['steps_per_s']:.2f} steps/s ({res['wall_s']:.3f} s), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")


def run_mixed(dev):
    """The mixed path at full width: P=512 over 100 steps (steps/s on the
    host clock, peak memory, launch counts), then P=10240 over 30 steps.
    Returns the P=512 run's (counts, res)."""
    r = mixed_runner(dev)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = clean(r.run(), "mixed")
    counts = dict(build.launch_counts)
    require(np.isfinite(res["est_poses"]).all(), "mixed: NaN in the poses")
    phase("mixed", f"P={P_MAIN} K=128+128 M=32, {MIXED_STEPS} steps: "
          f"{res['steps_per_s']:.2f} steps/s ({res['wall_s']:.3f} s), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
          f"overflow {res['overflow']}, final nEff {res['n_eff'][-1]:.3f}, "
          f"resampled {int(res['resampled'].sum())} steps")
    phase("mixed", "launches: " + ", ".join(f"{k}={counts.get(k, 0)}"
                                            for k in KERNELS))
    require(all(counts.get(k, 0) > 0 for k in MIXED_KERNELS),
            f"a kernel of the mixed path never launched: {counts}")

    r = mixed_runner(dev, P=P_MIXED_SCALE, T=MIXED_SCALE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    scale = clean(r.run(), f"mixed P={P_MIXED_SCALE}")
    require(np.isfinite(scale["est_poses"]).all(),
            f"mixed: NaN at P={P_MIXED_SCALE}")
    phase("mixed", f"P={P_MIXED_SCALE}, {MIXED_SCALE_STEPS} steps: "
          f"{scale['steps_per_s']:.2f} steps/s ({scale['wall_s']:.3f} s), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return counts, res


def mixed_accuracy(dev):
    """evaluate_mixed_mc over seeds 0-4 at P=256 (``eval/parity.py``, the
    JAX package's Monte-Carlo aggregate: a run whose movers are all out of
    sensor range at the last step has no dynamic OSPA, NaN by design, and
    is left out of that metric; a NaN anywhere else fails), each metric's
    mean beside the JAX package's 50-run mean +- 2 std, and the movers'
    detection by speed stratum."""
    require(list(MIXED_SEEDS) == list(range(len(MIXED_SEEDS))),
            "mixed accuracy: evaluate_mixed_mc runs seeds 0 .. n - 1")
    mc = evaluate_mixed_mc(n_runs=len(MIXED_SEEDS), n_particles=P_MIXED_ACC,
                           device=dev)
    for seed, r in zip(MIXED_SEEDS, mc["runs"]):
        clean(r["run"], f"mixed accuracy seed {seed}")
        require(np.isfinite(r["run"]["est_poses"]).all()
                and np.isfinite([r["mean_pose_err"], r["static_ospa"]]).all()
                and np.isfinite(r["dynamic_ospa"]) == (r["n_dyn_visible"] > 0),
                f"mixed accuracy: NaN in seed {seed}")
        phase("accuracy", f"seed {seed}: pose {r['mean_pose_err']:.4f} m, "
              f"static OSPA {r['static_ospa']:.4f}, dynamic OSPA "
              f"{r['dynamic_ospa']:.4f} ({r['n_dyn_visible']} movers "
              f"visible), {r['run']['steps_per_s']:.2f} steps/s")
    for k, agg in (("mean_pose_err", "pose"), ("static_ospa", "static_ospa"),
                   ("dynamic_ospa", "dynamic_ospa")):
        mean, std = mc[agg]
        n = sum(np.isfinite(r[k]) for r in mc["runs"])
        if not n:
            phase("accuracy", f"{k}: no run has a value")
            continue
        ref, ref_std = MIXED_BANDS[k]
        lo, hi = ref - 2 * ref_std, ref + 2 * ref_std
        phase("accuracy", f"{k} over {n} of seeds {list(MIXED_SEEDS)} "
              f"at P={P_MIXED_ACC}: {mean:.4f} +- {std:.4f}, "
              f"{'inside' if lo <= mean <= hi else 'outside'} the JAX "
              f"50-run band {ref} +- 2 x {ref_std}")
    phase("accuracy", "movers detected (dynamic map / either map): overall "
          f"{mc['det_overall']['dyn']:.3f} / {mc['det_overall']['either']:.3f}"
          "; by speed " + ", ".join(
              f"{name} m/s {v['dyn']:.3f} / {v['either']:.3f} of {v['n']}"
              for name, v in mc["det_strata"].items()))
    require(mc["pose"][0] <= ATE_LIMIT, f"mixed mean pose error "
            f"{mc['pose'][0]:.4f} m > {ATE_LIMIT} m")


# ----------------------------------------------------------------------------
# the estimators and routes: EAP, scheme 2, MC variance, shotgunning, T >= K
# ----------------------------------------------------------------------------

def check_estimator_steps(dev):
    """Step 40 of data/ackerman at P=512 on the card against the CPU twins
    (:func:`check_step`) under each estimator and route: scheme-2
    weighting, the MC variance on the det route and (step 5) on the full
    grid (the CPU run on the card's draws), shotgunning k=3, and the
    top-cap lane route T=128 >= K=128 with cap 512 on PHD and CPHD; then
    the EAP tree on the updated state of an EAP run against the CPU twin
    (:func:`check_eap_extract`). The full grid merges all 6320 lanes of a
    particle, and by step 40 a lane of weight ~1e-5 at the merge
    threshold can join a cluster on one device and not on the other (f32
    reassociation of its distance), moving the cluster's mean beyond the
    tolerance: its gate is taken early."""
    for cfg_path, over, n_before in (
            (CFG, S2, 40), (CFG, VAR, 40), (CFG, VAR_FULL, 5),
            (CFG, SHOT, 40), (CFG, TOPK, 40), (CPHD_CFG, TOPK, 40)):
        check_step(dev, n_before, overrides=over, cfg_path=cfg_path)
    r = check_step(dev, overrides=EAP)
    check_eap_extract(r, "ackerman")


def check_eap_extract(r, label):
    """The EAP tree on runner r's state on the card, each level's merge2d
    launch held against the twin on the same inputs
    (:func:`check_merge_rows`), and the whole tree on a CPU copy beside
    it: the final maps' difference is reported, not held (nine levels of
    f32 sums in another order compound, up to ~3e-4 relative in a
    covariance term)."""
    state = r.state
    levels = []

    def checked(packed, min_sep, cap, sorted_w=True, metric=0):
        out = merge2d(packed, min_sep, cap, sorted_w=sorted_w, metric=metric)
        got = merge_out(out, 2)
        want = merge_out(merge2d_reference(packed.cpu(), min_sep, cap,
                                           sorted_w, metric), 2)
        flips, err = check_merge_rows(got, want, packed, min_sep,
                                      f"EAP {label} level {len(levels)}")
        levels.append((tuple(packed.shape), int(got[3].sum()), err, flips))
        return out
    build.reset_launch_counts()
    with mock.patch.object(extras, "merge2d", checked):
        got = extract(state, r.cfg)[1]
    launches = build.launch_counts["merge2d"]
    want = extract(copy_state(state, "cpu"), r.cfg)[1]
    n_got, n_want = int((got[2] > 0).sum()), int((want[2] > 0).sum())
    flips = [f for lv in levels for f in lv[3]]
    phase("step", f"EAP tree {label} P={state.pose.shape[0]} at step "
          f"{state.step}: {launches} merge2d launches, each against the "
          f"twin on its inputs (B x C x N, clusters out, max |err|): "
          + "; ".join(f"{s[0]}x{s[1]}x{s[2]} {c} {e:.3g}"
                      for s, c, e, _ in levels)
          + f"; {len(flips)} particles part from the twin at a lane on the "
          f"merge threshold {[(p, c, d) for p, c, d in flips]}; the whole "
          f"tree on the card {n_got} clusters, weight "
          f"{float(got[2].sum()):.4f}, on the CPU {n_want}, max |err| "
          + (f"{max_err([(g.cpu(), w) for g, w in zip(got, want)]):.3g}"
             if n_got == n_want
             else "(counts differ)"))


def same_run(a, b, keys=("est_poses", "n_eff", "resampled")):
    """Two runner results equal bit for bit in ``keys``."""
    return all(np.array_equal(a[k], b[k]) for k in keys)


def band_line(label, rows, band, keys=("ate", "ospa")):
    """The port's mean and std over seeds (rows of (ATE, OSPA)) beside the
    JAX package's CPU band of the same P and seeds: the difference of the
    means and its standard error."""
    rows = np.asarray(rows)
    out = []
    for i, key in enumerate(keys):
        mean, std = rows[:, i].mean(), rows[:, i].std()
        j_mean, j_std = band[key]
        se = np.sqrt((std ** 2 + j_std ** 2) / len(rows))
        out.append(f"{key} {mean:.4f} +- {std:.4f} (JAX {j_mean:.4f} +- "
                   f"{j_std:.4f}; difference {mean - j_mean:+.4f}, standard "
                   f"error {se:.4f})")
    phase("bands", f"{label}: " + ", ".join(out))


def seed_band(dev, label, cfg_path, over, band, P=P_BAND, seeds=BAND_SEEDS):
    """evaluate_dataset over ``seeds`` at P particles: mean ATE and OSPA
    beside the JAX CPU band (:func:`band_line`); fails on NaN. Returns
    the rows (ATE, OSPA)."""
    rows = []
    for seed in seeds:
        res = evaluate_dataset(cfg_path, ".", device=dev,
                               overrides=dict(over, n_particles=P, seed=seed))
        require(np.isfinite(res["run"]["est_poses"]).all(),
                f"{label} seed {seed}: NaN")
        clean(res["run"], f"{label} seed {seed}")
        rows.append((res["mean_pose_err"], res["mean_ospa"]))
    band_line(f"{label} P={P} seeds {list(seeds)}", rows, band)
    return rows


def run_eap(dev, main_res, main_counts):
    """EAP extraction on data/ackerman at P=512 over the 331 steps with
    eap_every 1 and 5: every step's pose, nEff and resampling bit-equal to
    the plain run (extraction never touches the state), log2(512) = 9
    merge2d launches per extraction beyond the plain run's, and the EAP
    map's every-step OSPA(1, 5) beside the MAP run's; then dense P=1024
    with EAP against its plain run, and both packages' bands at P=128 over
    seeds 0-4 (EAP and MAP). Returns the P=512 EAP run's launch counts."""
    plain = main_res["run"]
    levels = int(np.ceil(np.log2(P_MAIN)))
    for every in (1, 5):
        counts, res = run_path(dev, "eap", CFG, dict(EAP, eap_every=every),
                               ACKERMAN_KERNELS)
        T = len(res["run"]["n_eff"])
        extra = counts["merge2d"] - main_counts["merge2d"]
        want = levels * len(range(0, T, every))
        phase("eap", f"eap_every {every}: OSPA(1, 5) EAP {res['mean_ospa']:.4f}"
              f" (final {res['final_ospa']:.4f}) beside MAP "
              f"{main_res['mean_ospa']:.4f} (final "
              f"{main_res['final_ospa']:.4f}); merge2d launches "
              f"{counts['merge2d']} = the plain run's "
              f"{main_counts['merge2d']} + {extra} ({levels} levels x "
              f"{want // levels} extractions)")
        require(extra == want, f"EAP eap_every {every}: {extra} merge2d "
                f"launches beyond the plain run, want {want}")
        require(same_run(res["run"], plain), f"EAP eap_every {every}: the "
                "state differs from the plain run's")
        if every == 1:
            eap_counts = counts
    phase("eap", "every pose, nEff and resampling decision bit-equal to the "
          "plain run at eap_every 1 and 5")
    _, dense_plain = run_path(dev, "eap", DENSE_CFG, {}, ACKERMAN_KERNELS,
                              P=P_DENSE)
    counts, dense = run_path(dev, "eap", DENSE_CFG, EAP, ACKERMAN_KERNELS,
                             P=P_DENSE)
    phase("eap", f"dense P={P_DENSE}: OSPA(1, 5) EAP {dense['mean_ospa']:.4f}"
          f" beside MAP {dense_plain['mean_ospa']:.4f}; state "
          + ("bit-equal" if same_run(dense["run"], dense_plain["run"])
             else "differs"))
    require(same_run(dense["run"], dense_plain["run"]),
            "EAP dense: the state differs from the plain run's")
    seed_band(dev, "EAP", CFG, EAP, EAP_CPU_BAND)
    seed_band(dev, "MAP", CFG, {}, PLAIN_CPU_BAND)
    return eap_counts


def eap_scene(dev, P=10240, K=1024, live=260, sites=300):
    """tools/bench_eap.py::tree_time's scene (cfg/dense.cfg, seed 0):
    every particle's K slots hold ``live`` weight-sorted components around
    ``sites`` shared sites (sd 0.3 m, covariance 0.1 I), uniform particle
    weights."""
    rng = np.random.default_rng(0)
    centers = rng.uniform(-40, 40, (sites, 2)).astype(np.float32)
    idx = rng.integers(0, sites, (P, K))
    mean = centers[idx] + rng.normal(0, 0.3, (P, K, 2)).astype(np.float32)
    w = np.zeros((P, K), np.float32)
    w[:, :live] = np.sort(rng.uniform(0.1, 1.0, (P, live))
                          .astype(np.float32), axis=1)[:, ::-1]
    mean[:, live:] = 0.0
    t = lambda x: torch.tensor(x, device=dev)
    gm = GMState(mean=t(mean), cov=(torch.eye(2, device=dev) * 0.1)
                 .expand(P, K, 2, 2).contiguous(), weight=t(w))
    return gm, torch.full((P,), -float(np.log(P)), device=dev)


def time_eap(dev):
    """One EAP extraction at P=10240, K=1024, ~260 live components a
    particle (:func:`eap_scene`): ms per extraction (CUDA events, the
    smallest of 5 after a warm-up), its merge2d launches, clusters and
    dropped count."""
    cfg = load_config(DENSE_CFG)
    gm, lw = eap_scene(dev)
    build.reset_launch_counts()
    m, c, w, dropped = extras.eap_expected_map(gm, lw, cfg,
                                               return_dropped=True)
    launches = build.launch_counts["merge2d"]
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        extras.eap_expected_map(gm, lw, cfg)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    require(bool(torch.isfinite(w).all()), "EAP scene: non-finite weights")
    phase("eap", f"one extraction P=10240 K=1024 ~260 live "
          f"(tools/bench_eap.py's scene): {min(times):.3f} ms (of "
          f"{', '.join(f'{x:.3f}' for x in times)}), {launches} merge2d "
          f"launches, {int((w > 0).sum())} clusters, weight "
          f"{float(w.sum()):.4f}, {int(dropped)} clusters dropped by the "
          "levels' caps")
    return min(times)


def run_variance(dev, main_res):
    """compute_variance on data/ackerman at P=512 over the 331 steps: every
    pose bit-equal to the plain run (the estimator draws from the runner's
    second generator), the variance finite after every step with
    measurements, its range and the share of negative estimates reported
    (``val (1 - val)`` is negative wherever a component's density at its
    own sample exceeds 1, in the JAX version as here); then 30 steps of the
    full grid with it. Returns the det-route run's steps/s."""
    cfg = load_config(CFG, dict(VAR, n_particles=P_MAIN))
    r = SynthSLAMRunner(cfg, DATA, device=dev)
    poses, v_min, v_max, v_neg, v_ok = [], [], [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in range(r.n_steps):
        out = r.step(n)
        poses.append(out.expected_pose)
        plan = r.schedule[n]
        if plan.z_idx >= 0 and r.z_mask[plan.z_idx].any():
            v = r.state.variance
            v_min.append(v.min())
            v_max.append(v.max())
            v_neg.append((v < 0).float().mean())
            v_ok.append(torch.isfinite(v).all())
    torch.cuda.synchronize()
    rate = r.n_steps / (time.perf_counter() - t0)
    poses = torch.stack(poses).cpu().numpy()
    v_min, v_max, v_neg = (torch.stack(v).cpu().numpy()
                           for v in (v_min, v_max, v_neg))
    same = np.array_equal(poses, main_res["run"]["est_poses"])
    phase("variance", f"data/ackerman P={P_MAIN} compute_variance "
          f"(n_samples {cfg.n_samples}), {r.n_steps} steps: {rate:.2f} "
          f"steps/s; per measurement step the particles' variance from "
          f"{np.median(v_min):.4g} to {np.median(v_max):.4g} (medians; "
          f"extremes {v_min.min():.4g}, {v_max.max():.4g}), negative in "
          f"{100 * v_neg.mean():.1f}% of particle-steps, > 0 in every "
          f"particle on {int((v_min > 0).sum())} of {len(v_min)} steps; poses "
          + ("bit-equal to the plain run" if same else "differ"))
    require(same, "variance: the poses differ from the plain run's")
    require(bool(torch.stack(v_ok).all()),
            "variance: not finite on every measurement step")
    _, full = run_path(dev, "variance", CFG, VAR_FULL, ("merge2d_argmax",),
                       n_steps=30)
    return rate


def run_shotgun(dev):
    """Shotgunning k=3 on data/ackerman at P=512 over the 331 steps, twice:
    every pose, nEff, resampling decision and MAP map bit-equal between the
    two runs; then the JAX CPU band at P=128 over seeds 0-4, and the mixed
    fast route at k=2 over 30 steps (no NaN). Returns the first run's
    launch counts."""
    runs = []
    for _ in range(2):
        counts, res = run_path(dev, "shotgun", CFG, SHOT, ACKERMAN_KERNELS)
        runs.append(res)
    same = same_run(runs[0]["run"], runs[1]["run"],
                    ("est_poses", "n_eff", "resampled", "map_means",
                     "map_weights"))
    phase("shotgun", f"k=3 P={P_MAIN} twice: "
          + ("every pose, nEff, decision and MAP map bit-equal" if same
             else "the runs differ"))
    require(same, "shotgun: a second run does not repeat the first")
    seed_band(dev, "shotgun k=3", CFG, SHOT, SHOT_CPU_BAND)
    z, mask = mixed_scans(30)
    r = ScanRunner(dataclasses.replace(mixed_cfg(P_MAIN),
                                       n_predict_particles=2),
                   z, mask, MIXED_DT, device=dev)
    build.reset_launch_counts()
    res = r.run()
    mixed_counts = dict(build.launch_counts)
    require(np.isfinite(res["est_poses"]).all()
            and np.isfinite(res["n_eff"]).all(), "shotgun mixed: NaN")
    require(all(mixed_counts.get(k, 0) > 0 for k in MIXED_KERNELS),
            f"shotgun mixed: a kernel never launched: {mixed_counts}")
    phase("shotgun", f"mixed fast route k=2 P={P_MAIN}, 30 steps: "
          f"{res['steps_per_s']:.2f} steps/s, no NaN, final nEff "
          f"{res['n_eff'][-1]:.3f}")
    return counts


def run_topk(dev):
    """The top-cap lane route (detection_topk 128 = K, cap 512) on
    data/ackerman, PHD and CPHD at P=512 over the 331 steps (no detect
    launch: gather_cols and merge2d only; ATE within 1.0 m), then each over
    seeds 0-2 against the JAX CPU runs of the same P and seeds. Returns
    the PHD run's launch counts."""
    out = None
    for label, cfg_path, band in (("PHD", CFG, TOPK_CPU_BAND),
                                  ("CPHD", CPHD_CFG, TOPK_CPHD_CPU_BAND)):
        counts, res = run_path(dev, "topk", cfg_path, TOPK, TOPK_KERNELS)
        require(counts.get("detect", 0) == 0, f"T >= K {label}: detect "
                "launched")
        require(res["mean_pose_err"] <= ATE_LIMIT, f"T >= K {label}: mean "
                f"ATE {res['mean_pose_err']:.4f} m > {ATE_LIMIT} m")
        seed_band(dev, f"T=128 {label}", cfg_path, TOPK, band, P=P_MAIN,
                  seeds=TOPK_SEEDS)
        out = out or counts
    return out


def run_scheme2(dev):
    """particle_weighting 2 on data/ackerman at P=512, 100 steps: no NaN,
    ATE reported (the scheme scores ~50 m on this dataset by design; no
    band)."""
    counts, res = run_path(dev, "scheme 2", CFG, S2, ACKERMAN_KERNELS,
                           n_steps=S2_STEPS)
    phase("scheme 2", f"{S2_STEPS} steps: mean ATE "
          f"{res['mean_pose_err']:.4f} m (no band: single-feature weighting "
          "on a multi-landmark map)")
    return counts


def eap_level1_calls(dev):
    """time_kernels' rows of merge2d at the EAP tree's first level on the
    maps of a real run's step 60 (the plain runner, extraction's inputs:
    each particle's map scaled by its weight, particles paired, each
    pair's lanes sorted): Ackerman P=512 (B=256, N=256) and dense P=1024
    (B=512, N=2048), each held against the twin first (counts equal,
    rtol 1e-4 / atol 1e-5), with the entering lanes, trips and rounds of
    each pair. Returns name -> (kernel, twin, twin iterations, library
    call, bound)."""
    rows = {}
    for tag, cfg_path, data, P in (("ackerman", CFG, DATA, P_MAIN),
                                   ("dense", DENSE_CFG, DENSE_DATA, P_DENSE)):
        cfg = load_config(cfg_path, {"n_particles": P})
        r = SynthSLAMRunner(cfg, data, device=dev)
        for n in range(60):
            r.step(n)
        planes = extras._scaled_planes(r.state.map_static,
                                       r.state.log_weight)
        B, C, L = planes.shape[0] // 2, planes.shape[1], planes.shape[2]
        packed = extras.sort_lanes_desc(
            planes.view(B, 2, C, L).transpose(1, 2).reshape(B, C, 2 * L))
        K, sep = cfg.max_components, float(cfg.min_separation)
        got = merge_out(merge2d(packed, sep, K), 2)
        want = merge_out(merge2d_reference(packed.cpu(), sep, K), 2)
        flips, err = check_merge_rows(got, want, packed, sep,
                                      f"merge2d EAP {tag}")
        lanes = round_stats(*merge_rounds(packed, sep, K))
        phase("captured", f"EAP level 1 {tag} step 60: merge2d B={B} "
              f"N={2 * L} K={K}: per pair {json.dumps(lanes)}; against the "
              f"twin max |err| {err:.3g} (rtol 1e-4, atol 1e-5, counts "
              f"equal), {len(flips)} pairs parting at a lane on the merge "
              f"threshold {flips}")
        rows[f"merge2d eap {tag} captured"] = (
            lambda a=(packed, sep, K): merge2d(*a),
            lambda a=(packed, sep, K): merge2d_reference(*a), 1, None,
            merge_bound(packed, K, 8, 27))
    return rows


def time_kernels(dev, errs, extra=None):
    """Kernel against twin at the main path's shapes, in turns
    (twin, kernel, library, kernel, library); CUDA events, ms per eager
    call, host included (gather_bench.time_call: 50 calls after 5; the
    twin its iterations once, with no warm-up call);
    the library call is one PyTorch call that computes the same function
    (gather_cols, gather_rows: torch.gather; cardinality_predict: the
    matmul its kernel folds in, ``lin @ T``), where there is one. Beside each, the device time of the
    kernel and of the library call (gather_bench.graph_ms: 50 calls
    replayed from a CUDA graph), printed and returned. The gathers run at
    every shape the paths launch (gather_calls), each call on the next of
    enough input sets to exceed the L2. The knob variants run at the shapes
    of the first path that launches them (detect_cons_adaptive: the dense
    path's; the rest: the Ackerman path's, on eval/scenes.py's scenes), and
    the dense path's kernels run at its shapes too (rows named "... dense",
    printed only, as are the two-kernel route's rows, which time the
    gather + combine + merge2d that merge2d_tables replaces on its
    inputs), and so do the update's kernels on the inputs captured from
    step 60 of real runs (rows "... captured", :func:`captured_calls`),
    and the argmax and Hellinger 3D/4D variants on captured inputs
    (:func:`variant_calls`).
    ``extra``: more rows in the same form (the staged wide-lane variants,
    :func:`run_wide`).
    Returns {name: (ms, plain_ms, library_ms, bound_ms, bound_by,
    device_ms, library_device_ms)}, the bound computed from these
    inputs."""
    cfg = load_config(CFG)
    min_fw, cb = cfg.min_feature_weight, cfg.clutter_density + cfg.birth_weight
    min_sep, h_sep = cfg.min_separation, HELL["min_separation"]
    planes, z4 = detect_inputs(dev)
    packed = merge_inputs(dev)
    grid = full_grid_inputs(dev)
    packed4 = merge4d_inputs(dev, N=128, seed=128)
    packed3 = merge3d_inputs(dev, seed=24)
    log_cn, log_b = cardinality_inputs(dev)
    lin, toep = toeplitz_operands(log_cn, log_b)
    log_cn_s, log_b_s = cardinality_inputs(dev, P=P_SCALE, seed=P_SCALE)
    lin_s, toep_s = toeplitz_operands(log_cn_s, log_b_s)
    T = 16
    # name: (kernel, twin, twin iterations, library call, bound)
    calls = {
        "detect": (lambda: detect(planes, z4, T, min_fw, cb),
                   lambda: detect_reference(planes, z4, T, min_fw, cb), 5,
                   None, detect_bound(planes, z4, T)),
        "merge2d": (lambda: merge2d(packed, min_sep, 128),
                    lambda: merge2d_reference(packed, min_sep, 128), 5, None,
                    merge_bound(packed, 128, 8, 27)),
        "merge2d_argmax": (
            lambda: merge2d(grid, min_sep, 128, False),
            lambda: merge2d_reference(grid, min_sep, 128, False), 2, None,
            merge_bound(grid, 128, 8, 27)),
        "merge2d_hellinger": (
            lambda: merge2d(packed, h_sep, 128, True, 1),
            lambda: merge2d_reference(packed, h_sep, 128, True, 1), 5, None,
            merge_bound(packed, 128, 8, 40)),
        "merge2d_argmax_hellinger": (
            lambda: merge2d(grid, h_sep, 128, False, 1),
            lambda: merge2d_reference(grid, h_sep, 128, False, 1), 2, None,
            merge_bound(grid, 128, 8, 40)),
        "merge4d": (lambda: merge4d(packed4, 2.0, 128),
                    lambda: merge4d_reference(packed4, 2.0, 128), 5, None,
                    merge_bound(packed4, 128, 16, 120)),
        "merge3d": (lambda: merge3d(packed3, 20.0, 24),
                    lambda: merge3d_reference(packed3, 20.0, 24), 5, None,
                    merge_bound(packed3, 24, 12, 70)),
        # the library call: the product alone, lin @ T, on the twin's
        # operands; at P=10240 too (printed only)
        "cardinality_predict": (
            lambda: cardinality_predict_batch(log_cn, log_b),
            lambda: cardinality_predict_reference(log_cn, log_b), 5,
            lambda: lin @ toep, cardinality_bound(log_cn, log_b)),
        f"cardinality_predict P={P_SCALE}": (
            lambda: cardinality_predict_batch(log_cn_s, log_b_s),
            lambda: cardinality_predict_reference(log_cn_s, log_b_s), 2,
            lambda: lin_s @ toep_s, cardinality_bound(log_cn_s, log_b_s)),
    }
    calls.update(gather_calls(dev))
    calls.update(knob_calls(dev, cfg))
    calls.update(variant_calls(dev, errs))
    calls.update(extra or {})
    times = {}
    for name, (kern, plain, iters, lib, (b_ms, b_by)) in calls.items():
        # kernel and library call in turns: the host's share of an eager
        # call drifts with the shared host's load. The plain version is
        # timed once, with no warm-up call of its own (up to 2.9 s a call):
        # the check phases ran it at these shapes
        p1 = time_call(plain, iters, 0)
        k1 = time_call(kern)
        l1 = None if lib is None else time_call(lib)
        k2 = time_call(kern)
        l2 = None if lib is None else time_call(lib)
        k_dev = graph_ms(kern)
        lib_ms = lib_dev = None
        if lib is not None:
            lib_ms, lib_dev = min(l1, l2), graph_ms(lib)
        times[name] = (min(k1, k2), p1, lib_ms, b_ms, b_by, k_dev, lib_dev)
        phase("timing", f"{name}: kernel {k1:.4f}/{k2:.4f} ms per call "
              f"({k_dev:.4f} on the device), plain {p1:.4f} ms per "
              f"call, bound {b_ms:.5f} ms ({b_by}, {100 * b_ms / k_dev:.0f}% "
              f"of the kernel's device time)"
              + ("" if lib_ms is None else
                 f", library call {lib_ms:.4f} ms per call ({lib_dev:.4f} "
                 f"on the device)"))
    return times


def gather_calls(dev):
    """time_kernels' rows of the two gathers at gather_bench.GATHER_TIMED
    (name -> kernel, twin, twin iterations, torch.gather, bound): the
    kernel's own name at its main shape (the column gather's t_k, the row
    gather's R=128) and, with "_ldg", above the shared-memory budget;
    "<kernel> <case>" for the rest. Kernel and torch.gather take the next
    of the case's input sets at each call (gather_bench.gather_sets); the
    twin the first; the bound is the mean over the sets."""
    fns = {"cols": (gather_cols, gather_cols_reference),
           "rows": (gather_rows, gather_rows_reference)}
    named = {"t_k": "gather_cols", "above budget": "gather_cols_ldg",
             "rows": "gather_rows", "rows above budget": "gather_rows_ldg"}
    calls = {}
    for case in GATHER_TIMED:
        kind, P, C, R, cap, _ = GATHER_CASES[case]
        kern, twin = fns[kind]
        sets = gather_sets(dev, case)
        idx, tab = sets[0][:2]
        name = named.get(case, f"gather_{kind} "
                         f"{case.removeprefix('rows ')}")
        calls[name] = (
            cycling(lambda i, t, a, x, k=kern: k(i, t), sets),
            lambda k=twin, i=idx, t=tab: k(i, t),
            2 if P * C * cap > 2 ** 22 else 5,
            cycling(lambda i, t, a, x: torch.gather(t, a, x), sets),
            (sum(gather_bound(s[0], C, R) for s in sets) / len(sets),
             "bytes"))
    return calls


def captured_calls(dev):
    """time_kernels' rows of the update's kernels on the exact inputs of
    real runs (detect_bench.capture_step): from step 60, detect and merge2d
    of Ackerman P=512 and of dense P=1024, detect_adaptive and
    merge2d_tables of dense fused + adaptive, detect_cons_adaptive of dense
    consolidating + adaptive, merge2d_argmax of the Ackerman full grid
    P=512, merge4d of the mixed bench P=512 ("merge4d mixed captured");
    from frame 20, merge3d of data/disparity P=512 ("merge3d disparity
    captured"). Each is held against its twin on those inputs first, and
    the live counts of the detect rows with a valid measurement and the
    entering lanes, trips and rounds (merge_bench.merge_rounds) of each
    merge particle are printed. Returns name -> (kernel, twin, twin
    iterations, library call, bound)."""
    rows = {}
    for run, tag in (("ackerman", ""), ("dense", " dense"),
                     ("dense fused + adaptive", " dense"),
                     ("dense consolidating + adaptive", " dense"),
                     ("full grid", ""), ("mixed", " mixed"),
                     ("disparity", " disparity")):
        calls, step = capture_step(dev, run)
        for kernel, (args, kw) in calls.items():
            if kernel in ("merge3d", "merge4d"):
                D = 3 if kernel == "merge3d" else 4
                fn, twin = ((merge3d, merge3d_reference) if D == 3
                            else (merge4d, merge4d_reference))
                packed, sep, K = args
                got = merge_out(fn(*args), D)
                want = merge_out(twin(*args), D)
                require(torch.equal(got[3], want[3])
                        and torch.equal(got[4], want[4]),
                        f"{kernel} captured {run}: counts differ from the "
                        "twin")
                for g, w in zip(got[:3], want[:3]):
                    torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
                lanes = round_stats(*merge_rounds(packed, sep, K))
                rows[f"{kernel}{tag} captured"] = (
                    lambda f=fn, a=args: f(*a), lambda f=twin, a=args: f(*a),
                    1, None, merge_bound(packed, K, OUT_PLANES[D],
                                         70 if D == 3 else 120))
                phase("captured", f"{run} step {step}: {kernel} P="
                      f"{packed.shape[0]} N={packed.shape[2]} K={K}: per "
                      f"particle {json.dumps(lanes)}; counts equal to the "
                      f"twin's, max |err| "
                      f"{max_err(list(zip(got[:3], want[:3]))):.3g} (rtol "
                      "1e-4, atol 1e-5)")
                continue
            if kernel == "detect":
                a = captured_args((args, kw))
                planes, z4, T = a[:3]
                got, name, err, flips = check_case(f"{run} captured", a)
                stats = live_counts(got[3], z4, T)
                rows[f"{name}{tag} captured"] = (
                    lambda a=a: detect(*a), lambda a=a: detect_reference(*a),
                    1, None, detect_bound(*a[:6]))
                phase("captured", f"{run} step {step}: {name} P="
                      f"{planes.shape[0]} K={planes.shape[2]} M="
                      f"{z4.shape[0]} T={T}: live lanes per valid row "
                      f"{json.dumps(stats)}; against the twin max |err| "
                      f"{err:.3g}, {flips} member flips at an f32 boundary")
                continue
            fused = kernel == "merge2d_tables"
            fn = merge2d_tables if fused else merge2d
            twin = merge2d_tables_reference if fused else merge2d_reference
            got = merge_out(fn(*args, **kw), 2)
            want = merge_out(twin(*args, **kw), 2)
            require(torch.equal(got[3], want[3])
                    and torch.equal(got[4], want[4]),
                    f"{kernel} captured {run}: counts differ from the twin")
            for g, w in zip(got[:3], want[:3]):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
            K, sep = (args[5], args[4]) if fused else (args[2], args[1])
            sorted_w, metric = kw.get("sorted_w", True), kw.get("metric", 0)
            if fused:
                ints, flts = args[:2]
                packed = tables_packed(*args[:4])
                b = tables_bound(ints, flts, K, 27)
            else:
                packed = args[0]
                b = merge_bound(packed, K, 8, 27)
            lanes = round_stats(*merge_rounds(packed, sep, K, sorted_w,
                                              metric))
            name = merge2d_variant(sorted_w, metric, tables=fused)
            rows[f"{name}{tag} captured"] = (
                lambda f=fn, a=args, k=kw: f(*a, **k),
                lambda f=twin, a=args, k=kw: f(*a, **k), 1, None, b)
            phase("captured", f"{run} step {step}: {name} P="
                  f"{packed.shape[0]} N={packed.shape[2]} K={K}: per "
                  f"particle {json.dumps(lanes)}; "
                  f"counts equal to the twin's, max |err| "
                  f"{max_err(list(zip(got[:3], want[:3]))):.3g} (rtol "
                  "1e-4, atol 1e-5)")
    return rows


def knob_calls(dev, cfg):
    """time_kernels' rows of the knob variants and of the dense path's
    kernels, then those of :func:`captured_calls`: name -> (kernel, twin,
    twin iterations, library call, bound)."""
    min_fw, cb = cfg.min_feature_weight, cfg.clutter_density + cfg.birth_weight
    T, K = 16, 128
    s = map_scene(cfg, P_MAIN, K, 48, 44, seed=0, device=dev)
    p6, z4 = detect_planes(cfg, s)
    p13, _ = detect_planes(cfg, s, consolidate=True)
    g, ints, flts = tables_payload(cfg, s)
    tabs = (ints, flts, g["t_k"], g["t_m"])
    h_sep = HELL["min_separation"]

    dcfg = load_config(DENSE_CFG)
    d_fw, d_cb = dcfg.min_feature_weight, \
        dcfg.clutter_density + dcfg.birth_weight
    dT, dK, d_sep = 32, 1024, dcfg.min_separation
    ds = map_scene(dcfg, P_DENSE, dK, 72, 65, seed=0, device=dev)
    d6, dz4 = detect_planes(dcfg, ds)
    d13, _ = detect_planes(dcfg, ds, consolidate=True)
    dg, dints, dflts = tables_payload(dcfg, ds)
    dtabs = (dints, dflts, dg["t_k"], dg["t_m"])
    dpacked = _finish_candidates_packed(dg, 2)
    rows = {
        "detect_adaptive": (
            lambda: detect(p6, z4, T, min_fw, cb, adaptive=True),
            lambda: detect_reference(p6, z4, T, min_fw, cb, adaptive=True),
            5, None, detect_bound(p6, z4, T)),
        "detect_cons": (
            lambda: detect(p13, z4, T, min_fw, cb, cfg.min_separation),
            lambda: detect_reference(p13, z4, T, min_fw, cb,
                                     cfg.min_separation), 5, None,
            detect_bound(p13, z4, T, min_fw, cb, cfg.min_separation)),
        "detect_cons_adaptive": (
            lambda: detect(d13, dz4, dT, d_fw, d_cb, d_sep, adaptive=True),
            lambda: detect_reference(d13, dz4, dT, d_fw, d_cb, d_sep), 2,
            None, detect_bound(d13, dz4, dT, d_fw, d_cb, d_sep)),
        "merge2d_tables": (
            lambda: merge2d_tables(*tabs, cfg.min_separation, K),
            lambda: merge2d_tables_reference(*tabs, cfg.min_separation, K),
            5, None, tables_bound(ints, flts, K, 27)),
        "merge2d_tables_hellinger": (
            lambda: merge2d_tables(*tabs, h_sep, K, 1),
            lambda: merge2d_tables_reference(*tabs, h_sep, K, 1), 5, None,
            tables_bound(ints, flts, K, 40)),
        "detect dense": (
            lambda: detect(d6, dz4, dT, d_fw, d_cb),
            lambda: detect_reference(d6, dz4, dT, d_fw, d_cb), 2, None,
            detect_bound(d6, dz4, dT)),
        "detect_adaptive dense": (
            lambda: detect(d6, dz4, dT, d_fw, d_cb, adaptive=True),
            lambda: detect_reference(d6, dz4, dT, d_fw, d_cb), 2, None,
            detect_bound(d6, dz4, dT)),
        "merge2d dense": (
            lambda: merge2d(dpacked, d_sep, dK),
            lambda: merge2d_reference(dpacked, d_sep, dK), 1, None,
            merge_bound(dpacked, dK, 8, 27)),
        "merge2d_tables dense": (
            lambda: merge2d_tables(*dtabs, d_sep, dK),
            lambda: merge2d_tables_reference(*dtabs, d_sep, dK), 1, None,
            tables_bound(dints, dflts, dK, 27)),
        # the two-kernel route the fused kernel replaces, on the same
        # tables: gather_cols x2, the combine's PyTorch ops, merge2d
        "two-kernel route": (
            lambda: merge2d(_finish_candidates_packed(g, 2),
                            cfg.min_separation, K),
            lambda: merge2d_reference(_finish_candidates_packed(g, 2),
                                      cfg.min_separation, K), 1, None,
            tables_bound(ints, flts, K, 27)),
        "two-kernel route dense": (
            lambda: merge2d(_finish_candidates_packed(dg, 2), d_sep, dK),
            lambda: merge2d_reference(dpacked, d_sep, dK), 1, None,
            tables_bound(dints, dflts, dK, 27)),
    }
    rows.update(captured_calls(dev))
    rows.update(eap_level1_calls(dev))
    return rows


def profile_step(r, label, host=(50, 60), prof=(60, 70), prefix="phd."):
    """Where the time goes for runner r (P=512 unless it holds another
    count): the steps of ``host`` on
    the host clock without the profiler and those of ``prof`` (as long)
    under torch.profiler, for the device time of each layer range (the
    ``prefix`` record_function spans, a string or a tuple of them, of
    filters/phd.py, filters/mixed.py, filters/cphd.py,
    filters/disparity.py) and each kernel. Earlier steps run
    unobserved."""
    steps = host[1] - host[0]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 0
    for kind, (lo, hi) in sorted((("host", host), ("prof", prof)),
                                 key=lambda w: w[1][0]):
        while n < lo:
            r.step(n)
            n += 1
        torch.cuda.synchronize()
        if kind == "host":
            t0 = time.perf_counter()
            while n < hi:
                r.step(n)
                n += 1
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1000.0 / steps
        else:
            with torch.profiler.profile(activities=acts) as prof_run:
                while n < hi:
                    r.step(n)
                    n += 1
                torch.cuda.synchronize()
    # device timeline: the layer ranges as GPU spans, and every kernel or
    # copy. A kernel launched through ctypes has no PyTorch op to correlate
    # with, so it can sit in the gap before its range's first PyTorch
    # kernel: each device event goes to the first span that ends after it
    # starts (its own span, or the next one when it sits in a gap).
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof_run.events() if e.device_type == cuda]
    spans = sorted((e for e in dev_events if e.name.startswith(prefix)),
                   key=lambda e: e.time_range.start)
    ends = [e.time_range.end for e in spans]
    per_layer = collections.defaultdict(float)
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        if e.name.startswith(prefix):
            continue
        i = bisect.bisect_right(ends, e.time_range.start)
        owner = spans[i].name if i < len(spans) else "(after the ranges)"
        per_layer[owner] += e.time_range.elapsed_us()
        per_kernel[e.name][0] += e.time_range.elapsed_us()
        per_kernel[e.name][1] += 1
    busy_ms = sum(per_layer.values()) / 1000.0 / steps
    idle = 100.0 * (1.0 - busy_ms / step_ms)
    n_launch = sum(c for _, c in per_kernel.values()) // steps
    phase("profile", f"{label} P={r.state.log_weight.shape[0]} steps "
          f"{host[0]}-{host[1] - 1}: "
          f"{step_ms:.3f} ms/step (host "
          f"clock, no profiler); steps {prof[0]}-{prof[1] - 1} profiled: "
          f"device busy "
          f"{busy_ms:.3f} ms/step (idle {idle:.1f}% of the unprofiled "
          f"step), {n_launch} device ops/step"
          + ("" if per_kernel else " - no device time recorded: not measured"))
    for name, us in sorted(per_layer.items(), key=lambda kv: -kv[1]):
        phase("profile", f"{label} {us / steps:9.1f} us/step busy  {name}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, cnt) in top:
        phase("profile", f"{label} {us / steps:9.1f} us/step "
              f"{cnt / steps:5.1f}/step  {name[:60]}")


# ----------------------------------------------------------------------------
# the runtime around the runner: the command line, logs, checkpoints, the
# Monte-Carlo batch and the NaN policy
# ----------------------------------------------------------------------------

JAX_MC_PHD_1024 = 1.97          # m: the JAX package's 50-run mean, P=1024
NAN_STEP = 20


def cli(argv):
    """``python -m phdslam_tpu_torch`` in this process on the card: its
    output, and its result line's steps/s (the runner's loop) beside the
    host clock around the whole command (set-up and log writing too)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    require(rc == 0, f"{argv}: exit code {rc}")
    done = [ln for ln in out.splitlines() if ln.startswith("done: ")]
    require(len(done) == 1, f"{argv}: no result line in {out!r}")
    return out, float(done[0].split()[3]), wall


def state_logs(out_dir):
    return sorted(f for f in os.listdir(out_dir)
                  if f.startswith("state_estimate"))


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def run_cli(dev, tmp, main_res):
    """``python -m phdslam_tpu_torch cfg/ackerman.cfg synth`` at P=512 over
    all 331 steps with a checkpoint every 160 steps (chunk 32): 331 state
    logs and loopTime.log lines, detect, gather_cols and merge2d launched,
    analyze_log_dir's mean ATE within ATE_LIMIT (beside the JAX band), the
    command's steps/s beside run_main's (no logs, same call) and the time
    write_logs takes; then resumed from step 160: every later log equal
    to the uninterrupted run's, byte for byte. Returns the output dir."""
    out = os.path.join(tmp, "cli")
    argv = [CFG, "synth", "--out-dir", out, "--particles", str(P_MAIN),
            "--chunk", "32", "--checkpoint-every", "160"]
    write_s, calls = [], []
    write_logs = SynthSLAMRunner.write_logs

    def timed_write_logs(self, log_dir, *args, **kwargs):
        t0 = time.perf_counter()
        write_logs(self, log_dir, *args, **kwargs)
        write_s.append(time.perf_counter() - t0)
        calls.append((self, args, kwargs))
    build.reset_launch_counts()
    with mock.patch.object(SynthSLAMRunner, "write_logs", timed_write_logs):
        _, loop_rate, wall = cli(argv)
    counts = dict(build.launch_counts)
    names = state_logs(out)
    T = len(names)
    lt = np.loadtxt(os.path.join(out, "loopTime.log"))
    require(T == 331 and len(lt) == 331 and (lt > 0).all(),
            f"cli: {T} state logs, {len(lt)} loopTime.log lines")
    require(all(counts.get(k, 0) > 0 for k in ACKERMAN_KERNELS),
            f"cli: a kernel of the path never launched: {counts}")
    require(sorted(os.listdir(os.path.join(out, "checkpoints")))
            == ["step00160", "step00320"], "cli: checkpoints")
    gt = np.load(f"{DATA}/groundtruth.npz")
    score = analyze_log_dir(out, gt["traj"], gt["landmarks"])
    ate = score["mean_pose_err"]
    lo, hi = ATE_BAND
    phase("cli", f"{' '.join(argv[:2])} P={P_MAIN}: {T} state logs, "
          f"loop {loop_rate:.2f} steps/s, whole command "
          f"{T / wall:.2f} steps/s ({wall:.3f} s; run_main without logs "
          f"{main_res['steps_per_s']:.2f}), write_logs "
          f"{write_s[0] * 1000.0 / T:.3f} ms/step ({write_s[0]:.3f} s)")
    # the same logs from the Python writer, the C++ writer's plain version
    plain_dir = os.path.join(tmp, "cli_python_writer")
    self, args, kwargs = calls[0]
    with mock.patch.object(rt_io, "write_state_log",
                           rt_io.write_state_log_reference):
        t0 = time.perf_counter()
        write_logs(self, plain_dir, *args, **kwargs)
        plain_s = [time.perf_counter() - t0]
    differ = [n for n in names if read_bytes(os.path.join(out, n))
              != read_bytes(os.path.join(plain_dir, n))]
    require(not differ and state_logs(plain_dir) == names,
            f"cli: {len(differ)} logs of the C++ writer differ from the "
            f"Python writer's, first {differ[:1]}")
    phase("cli", f"state logs: the C++ writer {write_s[0] * 1000.0 / T:.3f} "
          f"ms/step, the Python writer {plain_s[0] * 1000.0 / T:.3f} ms/step "
          f"on the same results in this call; all {T} logs byte-equal")
    phase("cli", f"analyze_log_dir: mean ATE {ate:.4f} m "
          f"({'inside' if lo <= ate <= hi else 'outside'} the JAX band "
          f"{lo}-{hi} m), OSPA(1, 5) every 10th log against every landmark "
          f"{score['mean_ospa']:.4f}, mean nEff "
          f"{float(np.mean(score['n_eff'])):.4f}")
    phase("cli", "launches: " + ", ".join(f"{k}={counts.get(k, 0)}"
                                          for k in ACKERMAN_KERNELS))
    require(ate <= ATE_LIMIT, f"cli: mean ATE {ate:.4f} m > {ATE_LIMIT} m")

    res_dir = os.path.join(tmp, "cli_resumed")
    text, _, _ = cli(argv[:3] + [res_dir] + argv[4:6] + [
        "--chunk", "32", "--resume",
        os.path.join(out, "checkpoints", "step00160")])
    later = state_logs(res_dir)
    require(later == names[160:], f"cli resume: {len(later)} logs")
    differ = [n for n in later if read_bytes(os.path.join(out, n))
              != read_bytes(os.path.join(res_dir, n))]
    require(not differ, f"cli resume: {len(differ)} logs differ, first "
            f"{differ[:1]}")
    phase("cli", f"resumed at step 160 ({text.splitlines()[0]}): all "
          f"{len(later)} later logs byte-equal to the uninterrupted run's")
    return out


def run_cli_timing(dev, tmp, full):
    """``--timing`` over the first 60 steps: predicttime.log positive on
    every step that predicts, and every pose bit-equal to the untimed
    run's (the timed prediction reuses the step's own draws)."""
    out = os.path.join(tmp, "cli_timing")
    _, rate, _ = cli([CFG, "synth", "--out-dir", out, "--particles",
                      str(P_MAIN), "--steps", "60", "--timing"])
    r = SynthSLAMRunner(load_config(CFG, {"n_particles": P_MAIN,
                                          "n_steps": 60}), DATA, device=dev)
    predicts = np.asarray([p.do_predict for p in r.schedule])
    pt = np.loadtxt(os.path.join(out, "predicttime.log"))
    lt = np.loadtxt(os.path.join(out, "loopTime.log"))
    require(len(pt) == len(lt) == 60 and (pt[predicts] > 0).all()
            and (pt[~predicts] == 0).all(), "cli timing: predicttime.log")
    names = state_logs(out)
    require(names == state_logs(full)[:60], "cli timing: logs")
    same = 0
    for n in names:
        a = read_bytes(os.path.join(out, n)).split(b"\n")
        b = read_bytes(os.path.join(full, n)).split(b"\n")
        require(a[0] == b[0] and a[4] == b[4],
                f"cli timing: {n} poses differ from the untimed run")
        same += a == b
    phase("cli timing", f"60 steps --timing: {rate:.2f} steps/s, step "
          f"{float(np.median(lt)):.3f} ms median, prediction "
          f"{float(np.median(pt[predicts])):.3f} ms median on "
          f"{int(predicts.sum())} predicting steps; expected and particle "
          f"poses bit-equal to the untimed run, {same}/60 logs byte-equal")


def run_cli_trace(dev, tmp):
    """``--trace`` over 20 steps: the exported Chrome trace holds the
    merge2d and detect kernels' device events."""
    out, tdir = os.path.join(tmp, "cli_trace"), os.path.join(tmp, "trace")
    cli([CFG, "synth", "--out-dir", out, "--particles", str(P_MAIN),
         "--steps", "20", "--trace", tdir])
    with open(os.path.join(tdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = collections.Counter(
        e["name"] for e in events if e.get("cat") == "kernel")
    found = {k: sum(c for name, c in kernels.items() if k in name)
             for k in ("merge2d", "detect")}
    require(all(found.values()), f"cli trace: kernel events {found}; "
            f"{len(kernels)} kernel names")
    phase("cli trace", f"20 steps: {sum(kernels.values())} kernel events "
          f"({len(kernels)} names), merge2d {found['merge2d']}, detect "
          f"{found['detect']}")


def run_profile_update(dev, full):
    """profile_single_update on the CLI run's step-160 checkpoint with step
    160's scan: one timed update (CUDA events)."""
    cfg = load_config(CFG, {"n_particles": P_MAIN})
    r = SynthSLAMRunner(cfg, DATA, device=dev)
    plan = r.schedule[160]
    res = profile_single_update(
        cfg, os.path.join(full, "checkpoints", "step00160"),
        r.z[plan.z_idx], r.z_mask[plan.z_idx], device=dev)
    require(np.isfinite(res["est_poses"]).all(), "profile: NaN pose")
    n_z = int(r.z_mask[plan.z_idx].sum())
    phase("profile", f"single update at step 160 ({n_z} measurements, "
          f"P={P_MAIN}): update_ms {res['update_ms']:.4f} (CUDA events, no "
          "prediction)")


def run_disparity_cli(dev, tmp):
    """``python -m phdslam_tpu_torch cfg/disparity.cfg disparity`` at
    P=512: trajectory.txt over the 80 frames, merge3d launched."""
    out = os.path.join(tmp, "cli_disparity")
    build.reset_launch_counts()
    _, rate, _ = cli([DISP_CFG, "disparity", "--out-dir", out,
                      "--particles", str(P_MAIN)])
    counts = dict(build.launch_counts)
    est = np.loadtxt(os.path.join(out, "trajectory.txt"))
    lt = np.loadtxt(os.path.join(out, "loopTime.log"))
    require(est.shape == (80, 12) and np.isfinite(est).all()
            and len(lt) == 80, f"disparity cli: trajectory {est.shape}")
    require(counts.get("merge3d", 0) > 0, f"disparity cli: {counts}")
    phase("disparity cli", f"80 frames P={P_MAIN}: {rate:.2f} steps/s, "
          f"merge3d={counts.get('merge3d', 0)}")


def run_batch_phase(dev, tmp):
    """The Monte-Carlo batch on ``tools/mc_scale.py``'s worlds (40
    landmarks, 150 steps, dt 0.1, seed 11), four runs of its PHD
    configuration at P=1024: every run finite, the summary beside the JAX
    package's 50-run mean (four runs hold no 50-run band)."""
    root = os.path.join(tmp, "mc")
    generate_batch_datasets(root, n_runs=4, n_landmarks=40, n_steps=150,
                            dt=0.1, seed=11)
    gt = np.load(os.path.join(root, "groundtruth.npz"))
    # tools/mc_scale.py::base_cfg, PHD, at P=1024
    cfg = SlamConfig(
        n_particles=1024, max_features=64, max_measurements=64,
        motion_type=1, feature_model=0, filter_type=0, max_cardinality=64,
        l=2.83, h=0.76, a=3.78, b=0.5, std_encoder=2.0, std_alpha=0.0873,
        max_range=10.0, std_range=1.0, std_bearing=0.0349,
        clutter_rate=5.0, pd=0.95, birth_weight=0.05, min_separation=5.0,
        particle_weighting=0, resample_threshold=0.15, dt=0.1, seed=9,
        x0=float(gt["traj"][0, 0]), y0=float(gt["traj"][0, 1]))
    build.reset_launch_counts()
    res = run_batch(cfg, root, ospa_every=1, device=dev)
    counts = dict(build.launch_counts)
    require(np.isfinite(res.pose_err).all() and np.isfinite(res.ospa).all()
            and np.isfinite(res.n_eff).all(), "batch: a run is not finite")
    s = res.summary()
    phase("batch", f"PHD P=1024, {s['n_runs']} runs x 150 steps: pose "
          f"{s['mean_pose_err']:.4f} +- {s['std_pose_err']:.4f} m (JAX 50 "
          f"runs {JAX_MC_PHD_1024} m), OSPA {s['mean_ospa']:.4f} +- "
          f"{s['std_ospa']:.4f}, final pose {s['final_pose_err']:.4f} m, "
          f"{s['mean_steps_per_s']:.2f} steps/s; per run pose "
          + ", ".join(f"{v:.4f}" for v in res.pose_err.mean(axis=1))
          + "; launches " + ", ".join(f"{k}={counts.get(k, 0)}"
                                      for k in ACKERMAN_KERNELS))


def run_nan(dev):
    """NaN log weights injected before step 20 of a 40-step Ackerman run
    at P=512: the run completes on the card, prints the first NaN step and
    returns nan_step = 20; with debug=True it raises FloatingPointError."""
    def runner():
        r = SynthSLAMRunner(load_config(CFG, {"n_particles": P_MAIN,
                                              "n_steps": 40}), DATA,
                            device=dev)
        step = r.step

        def poisoned(n, noise=None):
            if n == NAN_STEP:
                r.state = r.state.replace(
                    log_weight=r.state.log_weight * float("nan"))
            return step(n, noise)
        r.step = poisoned
        return r
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = runner().run()
    torch.cuda.synchronize()
    said = buf.getvalue()
    require(res["nan_step"] == NAN_STEP
            and said == f"nan weights detected at step {NAN_STEP}!\n"
            and np.isfinite(res["n_eff"][:NAN_STEP]).all(),
            f"nan: nan_step {res['nan_step']}, printed {said!r}")
    try:
        runner().run(debug=True)
    except FloatingPointError as e:
        raised = str(e)
    else:
        raised = None
    torch.cuda.synchronize()
    require(raised == f"nan weights detected at step {NAN_STEP}",
            f"nan: debug run raised {raised!r}")
    phase("nan", f"NaN log weights at step {NAN_STEP} of 40: printed "
          f"{said.strip()!r}, nan_step {res['nan_step']}, "
          f"{int(np.isnan(res['n_eff']).sum())} NaN nEff steps, no CUDA "
          f"error; debug=True raised FloatingPointError({raised!r})")


def run_runtime(dev, main_res):
    """The runtime phases in one scratch directory, removed after."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        full = run_cli(dev, tmp, main_res)
        run_cli_timing(dev, tmp, full)
        run_cli_trace(dev, tmp)
        run_profile_update(dev, full)
        run_disparity_cli(dev, tmp)
        run_batch_phase(dev, tmp)
        run_nan(dev)
    phase("runtime", f"cli, timing, trace, profile, disparity cli, batch "
          f"and nan phases: {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------------------
# the mixed model's per-particle route and the options once refused
# ----------------------------------------------------------------------------

def slow_runner(dev, P=P_MAIN, T=MIXED_STEPS, **overrides):
    """The mixed bench's ScanRunner on the per-particle route (plus
    ``overrides``) at P particles over T scans."""
    z, mask = mixed_scans(T)
    cfg = dataclasses.replace(mixed_cfg(P), **dict(SLOW, **overrides))
    return ScanRunner(cfg, z, mask, MIXED_DT, device=dev)


def run_mixed_slow(dev, fast_res):
    """The per-particle route at full width: the mixed bench's
    configuration (P=512, K=128, M=32, cap 512, merge_candidate_cap_dynamic
    128) over its 100 scans, with merge2d's and merge4d's
    argmax modes required and no NaN; then weighting 2 and
    compute_variance (which take the route too) over 30 scans each, the
    variance required zero (the route estimates none). Steps/s beside the
    fast route's run in this call. Returns the 100-step run's launch
    counts and result."""
    r = slow_runner(dev)
    require(not mixed_filter.uses_fast_route(r.cfg, 128, 32),
            "mixed slow: the configuration takes the fast route")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = clean(r.run(), "mixed slow")
    counts = dict(build.launch_counts)
    require(np.isfinite(res["est_poses"]).all()
            and np.isfinite(res["n_eff"]).all(), "mixed slow: NaN")
    require(all(counts.get(k, 0) > 0 for k in MIXED_SLOW_KERNELS),
            f"a kernel of the per-particle route never launched: {counts}")
    dyn = r.state.map_dynamic.weight
    phase("mixed slow", f"per-particle route P={P_MAIN} K=128+128 M=32, "
          f"{SLOW_STEPS} steps: {res['steps_per_s']:.2f} steps/s "
          f"({res['wall_s']:.3f} s; the fast route in this call "
          f"{fast_res['steps_per_s']:.2f}, ratio "
          f"{fast_res['steps_per_s'] / res['steps_per_s']:.2f}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, overflow "
          f"{res['overflow']}, final nEff {res['n_eff'][-1]:.3f}, mean live "
          f"dynamic components {float((dyn > 0).sum(1).float().mean()):.1f}")
    phase("mixed slow", "launches: " + ", ".join(
        f"{k}={counts.get(k, 0)}" for k in KERNELS))
    for label, over in (("weighting 2", {"particle_weighting": 2}),
                        ("compute_variance", {"compute_variance": True})):
        r2 = slow_runner(dev, T=SLOW_OPTION_STEPS, mixed_fast_path=1, **over)
        require(not mixed_filter.uses_fast_route(r2.cfg, 128, 32),
                f"mixed {label}: the configuration takes the fast route")
        build.reset_launch_counts()
        res2 = clean(r2.run(), f"mixed {label}")
        c2 = dict(build.launch_counts)
        require(np.isfinite(res2["est_poses"]).all(), f"mixed {label}: NaN")
        require(all(c2.get(k, 0) > 0 for k in MIXED_SLOW_KERNELS),
                f"mixed {label}: argmax merges not launched: {c2}")
        if "variance" in label:
            require(bool((r2.state.variance == 0).all()),
                    "mixed compute_variance: a variance was estimated")
        phase("mixed slow", f"{label}, {SLOW_OPTION_STEPS} steps: "
              f"{res2['steps_per_s']:.2f} steps/s, overflow "
              f"{res2['overflow']}, final nEff {res2['n_eff'][-1]:.3f}"
              + (", variance all zero" if "variance" in label else ""))
    return counts, res


def check_mixed_slow_step(dev, n_before=40):
    """From step 40 of the per-particle route at full width: one step on
    the card against the CPU twins (:func:`step_against_cpu`, the
    tolerances of :func:`check_mixed_step`), then the card's per-particle
    route against its fast route on one state (step 40's, predicted
    without noise, its scan; the fast route at detection_topk = K, so that
    both merge the same top-cap lanes): log weights within 2e-5, map
    weights rtol 2e-4 / atol 2e-5, live means rtol 2e-4 / atol 2e-4 (the
    JAX package's test_mixed_fast_path_matches_slow)."""
    r = slow_runner(dev)
    for n in range(n_before):
        r.step(n)
    state0 = copy_state(r.state, dev)
    err, cpu_state, n_edge, n_swap = step_against_cpu(r, n_before)
    phase("step", f"mixed per-particle step {n_before} at P={P_MAIN}: card "
          f"vs CPU twins max |err| {err:.3g} (rtol 1e-4, atol 1e-5), "
          f"overflow equal; {n_swap} weight-tied slots swapped, {n_edge} "
          "resampling strata at a cumulative-weight boundary")
    z, zm = r.step_args(n_before)[:2]
    st = predict(state0, (0.0, 0.0), MIXED_DT, r.cfg,
                 torch.zeros((1, P_MAIN, 3), device=dev))
    slow, _ = mixed_filter.mixed_update(st, z, zm, r.cfg)
    fast, _ = mixed_filter.mixed_update(
        st, z, zm, dataclasses.replace(r.cfg, mixed_fast_path=1,
                                       detection_topk=128))
    worst = 0.0
    torch.testing.assert_close(fast.log_weight, slow.log_weight, rtol=2e-5,
                               atol=2e-5)
    for name in ("map_static", "map_dynamic"):
        gf, gs = getattr(fast, name), getattr(slow, name)
        torch.testing.assert_close(gf.weight, gs.weight, rtol=2e-4,
                                   atol=2e-5)
        live = gs.weight > 1e-6
        torch.testing.assert_close(gf.mean[live], gs.mean[live], rtol=2e-4,
                                   atol=2e-4)
        worst = max(worst, max_err([(gf.weight, gs.weight),
                                    (gf.mean[live], gs.mean[live])]))
    phase("step", f"mixed per-particle vs fast route on the card, scan "
          f"{n_before} from step {n_before}'s state: max |err| "
          f"{worst:.3g} (log weights 2e-5, rtol 2e-4)")


def mixed_option_accuracy(dev):
    """evaluate_mixed over MIXED_SEEDS at P=256 with each of the options
    once refused (MIXED_OPTIONS), beside the JAX package's CPU runs of
    the same seeds and overrides (MIXED_OPTION_CPU): both means, their
    difference and its standard error. Fails on NaN other than the
    dynamic OSPA of a run with no mover in range, and on a mean pose error
    above 1.0 m. Returns the launch counts of the distance_metric=1 runs
    (the fast route's merge2d_hellinger and merge4d_hellinger required)."""
    keys = ("mean_pose_err", "static_ospa", "dynamic_ospa")
    hell_counts = None
    for label, over in MIXED_OPTIONS.items():
        rows = []
        build.reset_launch_counts()
        for seed in MIXED_SEEDS:
            r = evaluate_mixed(seed=seed, n_particles=P_MIXED_ACC,
                               cfg_overrides=over, device=dev)
            clean(r["run"], f"mixed {label} seed {seed}")
            require(np.isfinite(r["run"]["est_poses"]).all()
                    and np.isfinite([r["mean_pose_err"],
                                     r["static_ospa"]]).all()
                    and (np.isfinite(r["dynamic_ospa"])
                         == (r["n_dyn_visible"] > 0)),
                    f"mixed {label}: NaN in seed {seed}")
            rows.append([float(r[k]) for k in keys])
        rows = np.asarray(rows)
        ref = np.asarray(MIXED_OPTION_CPU.get(label, []), float)
        out = []
        for i, k in enumerate(keys):
            v = rows[:, i][np.isfinite(rows[:, i])]
            if not len(v):
                out.append(f"{k}: no run has a value")
                continue
            m, sd = float(v.mean()), float(v.std(ddof=1)) if len(v) > 1 \
                else 0.0
            text = f"{k} {m:.4f} +- {sd:.4f} (n={len(v)})"
            if ref.size:
                j = ref[:, i][np.isfinite(ref[:, i])]
                jm, jsd = float(j.mean()), float(j.std(ddof=1)) if \
                    len(j) > 1 else 0.0
                se = float(np.sqrt(sd ** 2 / len(v) + jsd ** 2 / len(j)))
                text += (f" vs JAX CPU {jm:.4f} +- {jsd:.4f} (n={len(j)}): "
                         f"difference {m - jm:+.4f}, standard error "
                         f"{se:.4f}")
            out.append(text)
        phase("accuracy", f"mixed {label} P={P_MIXED_ACC} seeds "
              f"{list(MIXED_SEEDS)}: " + "; ".join(out))
        pose = float(rows[:, 0].mean())
        require(pose <= ATE_LIMIT, f"mixed {label}: mean pose error "
                f"{pose:.4f} m > {ATE_LIMIT} m")
        if over.get("distance_metric") == 1:
            hell_counts = dict(build.launch_counts)
            require(all(hell_counts.get(k, 0) > 0
                        for k in ("merge2d_hellinger", "merge4d_hellinger")),
                    f"mixed Hellinger: launches {hell_counts}")
    return hell_counts


def run_options(dev, cphd_res):
    """The options the filters once refused, on the paths' data: static
    Vo weighting (particle_weighting 1) on data/ackerman at P=512 on the
    det route (the whole sequence and its first 100 steps, beside the JAX
    CPU band of 100 steps), the top-cap lane route (detection_topk 128)
    and the full grid (30 steps); CPHD with compute_variance (poses
    bit-equal to the plain CPHD run of this call, the variance all zero);
    data/disparity (80 frames) at weighting 2 and with the Hellinger merge
    (merge3d_hellinger launched). Returns the disparity Hellinger run's
    launch counts."""
    for label, over, n in (("det", {}, None), ("det", {}, W1_STEPS),
                           ("top-cap lanes", TOPK, None),
                           ("full grid", {"merge_candidate_cap": 0},
                            W1_FULL_STEPS)):
        kernels = (ACKERMAN_KERNELS if label == "det" else TOPK_KERNELS
                   if label == "top-cap lanes" else FULL_GRID_KERNELS)
        # no ATE bound: Vo's weighting tracks data/ackerman worse than the
        # cluster process in both packages (W1_CPU_BAND); NaN fails
        _, res = run_path(dev, f"weighting 1 {label}", CFG, dict(W1, **over),
                          kernels, n_steps=n)
        if label == "det" and n == W1_STEPS and W1_CPU_BAND:
            for key, val in (("ate", res["mean_pose_err"]),
                             ("ospa", res["mean_ospa"])):
                ref, std = W1_CPU_BAND[key]
                phase("weighting 1", f"first {n} steps mean {key} {val:.4f} "
                      f"beside the JAX CPU band {ref} +- {std} (seeds 0-2 at "
                      f"P={P_MAIN}, {n} steps)")
    cfg = load_config(CPHD_CFG, {"n_particles": P_MAIN, **VAR})
    r = SynthSLAMRunner(cfg, DATA, device=dev)
    res = clean(r.run(), "CPHD compute_variance")
    same = np.array_equal(res["est_poses"], cphd_res["run"]["est_poses"])
    zero = bool((r.state.variance == 0).all())
    phase("options", f"CPHD + compute_variance P={P_MAIN}, "
          f"{len(res['est_poses'])} steps: {res['steps_per_s']:.2f} steps/s, "
          f"poses bit-equal to the plain CPHD run: {same}, variance all "
          f"zero: {zero}")
    require(same and zero, "CPHD compute_variance changed the run")
    counts = None
    for label, over, kernels in (
            ("weighting 2", {"particle_weighting": 2}, DISP_KERNELS),
            ("hellinger", {"distance_metric": 1, "min_separation": 0.6},
             DISP_HELL_KERNELS)):
        r = disparity_runner(dev, **over)
        build.reset_launch_counts()
        res = clean(r.run(), f"disparity {label}")
        c = dict(build.launch_counts)
        gt = np.load(f"{DISP_DATA}/groundtruth.npz")
        est = res["est_poses"]
        require(np.isfinite(est).all(), f"disparity {label}: NaN")
        err = np.linalg.norm(est[:, :3] - gt["traj"][:len(est), :3], axis=1)
        est_map = disparity_map_estimate(r.state)
        o, _, _ = ospa_distance(gt["landmarks"], est_map, p=1, c=1.0)
        n_z = int(r.has_z.sum())
        require(all(c.get(k, 0) == n_z > 0 for k in kernels),
                f"disparity {label}: launches {c}, frames with "
                f"measurements {n_z}")
        phase("options", f"data/disparity {label} P={P_MAIN}, {len(est)} "
              f"frames: {res['steps_per_s']:.2f} steps/s, mean pose error "
              f"{err.mean():.4f} m, OSPA(1, 1 m) {o:.4f}; launches "
              + ", ".join(f"{k}={c.get(k, 0)}" for k in kernels))
        counts = c
    return counts


def variant_calls(dev, errs):
    """time_kernels' rows of the newer merge variants on captured inputs:
    merge4d's argmax mode on the dynamic map's merge at step 60 of the
    per-particle route (mixed bench P=512), and the Hellinger variants on
    the inputs captured from step 60 of the mixed bench (merge4d) and
    frame 20 of data/disparity (merge3d) at HELL's min_separation. Each is
    held against its twin first (the largest |difference| into ``errs``);
    a particle that parts from the twin at a lane within 1e-5 of
    min_separation (float64) is counted, not failed. Returns name ->
    (kernel, twin, twin iterations, library call, bound), the rows named
    by their kernel variant."""
    rows = {}
    r = slow_runner(dev, T=61)
    calls = {}

    def spy(*args, **kw):
        if r.state.step == 60 and "merge4d" not in calls:
            calls["merge4d"] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args), kw
        return merge4d(*args, **kw)
    with mock.patch.object(phd_filter, "merge4d", spy):
        for n in range(61):
            r.step(n)
    (packed, sep, K), kw = calls["merge4d"]
    require(kw.get("sorted_w", True) is False,
            "mixed slow: the dynamic merge is not the argmax mode")
    sources = [("merge4d_argmax", "mixed slow", packed, sep, K, False, 0)]
    for run, kernel in (("mixed", "merge4d"), ("disparity", "merge3d")):
        got_calls, _ = capture_step(dev, run)
        (pk, _, Kc), _ = got_calls[kernel]
        sources.append((f"{kernel}_hellinger", run, pk,
                        HELL["min_separation"], Kc, True, 1))
    for name, run, pk, sep, K, sorted_w, metric in sources:
        D = MERGE_DIMS[pk.shape[1]]
        fn, twin = (merge3d, merge3d_reference) if D == 3 else (
            merge4d, merge4d_reference)
        kw = dict(metric=metric) if D == 3 else dict(sorted_w=sorted_w,
                                                     metric=metric)
        got = merge_out(fn(pk, sep, K, **kw), D)
        want = merge_out(twin(pk.cpu(), sep, K, **kw), D)
        flips, err = check_merge_rows(got, want, pk, sep, f"{name} {run}",
                                      metric)
        lanes = round_stats(*merge_rounds(pk, sep, K, sorted_w, metric))
        errs[name] = err
        rows[name] = (
            lambda f=fn, a=(pk, sep, K), k=kw: f(*a, **k),
            lambda f=twin, a=(pk, sep, K), k=kw: f(*a, **k), 1, None,
            merge_bound(pk, K, OUT_PLANES[D],
                        {3: 70, 4: 120}[D] * (2 if metric else 1)))
        phase("captured", f"{run} step 60 (disparity: frame 20): {name} P="
              f"{pk.shape[0]} N={pk.shape[2]} K={K} min_sep {sep}: per "
              f"particle {json.dumps(lanes)}; against the twin max |err| "
              f"{err:.3g} (rtol 1e-4, atol 1e-5), {len(flips)} particles "
              f"parting at a lane within 1e-5 of min_sep (float64) "
              f"{[(p, c, d) for p, c, d in flips]}")
    return rows

# ----------------------------------------------------------------------------
# the spatially tiled merge (phase "tiles")
# ----------------------------------------------------------------------------

TILED = {"merge_spatial_tiles": 4}
TILE_CAPTURE = 60               # the dense tiled run's merge captured
# the JAX package's CPU runs of the Ackerman configuration at P=128 with
# tiles on, seeds 0-4 (reference_band.py cfg/ackerman.cfg --particles 128
# --seeds 0 1 2 3 4 --set merge_spatial_tiles=4 pallas_merge=2: the JAX
# package tiles only through its Pallas kernels, run here in interpret
# mode): mean ATE and every-step OSPA(1, 5) per seed
TILED_CPU_SEEDS = {"ate": (0.4807, 0.7473, 1.1291, 0.5190, 0.6367),
                   "ospa": (1.9468, 2.0585, 2.1822, 1.9934, 2.0642)}
TILED_CPU_BAND = {k: (float(np.mean(v)), float(np.std(v)))
                  for k, v in TILED_CPU_SEEDS.items()}


@contextlib.contextmanager
def tile_choices():
    """The tiled-or-untiled choices made inside the block, in order:
    (candidate width N, tile row width ct; 0 untiled)."""
    got = []
    real = phd_filter.tile_width

    def spy(N, n_tile):
        ct = real(N, n_tile)
        got.append((N, ct))
        return ct
    with mock.patch.object(phd_filter, "tile_width", spy):
        yield got


def tile_step(dev, label, r, n_before=40, advance=True):
    """Step ``n_before`` of runner r (tiles on; stepped there first unless
    ``advance`` is False) on the card against the CPU twins
    (:func:`step_against_cpu`): every merge of the card took the CPU's
    tiled-or-untiled choice at the same widths."""
    for n in range(n_before if advance else 0):
        r.step(n)
    with tile_choices() as got:
        err, cpu_state, n_edge, n_swap = step_against_cpu(r, n_before)
    half = len(got) // 2
    require(len(got) == 2 * half and got[:half] == got[half:],
            f"tiles {label}: the card's choices {got[:half]}, the CPU's "
            f"{got[half:]}")
    phase("tiles", f"{label} step {n_before}: card vs CPU twins max |err| "
          f"{err:.3g} (rtol 1e-4, atol 1e-5), overflow equal; merges "
          f"(N, tile row width; 0 untiled) {got[:half]} on both; {n_swap} "
          f"weight-tied slots swapped, {n_edge} resampling strata at a "
          "cumulative-weight boundary")
    return got[:half]


def tile_steps(dev):
    """One step with tiles on of each path that tiles, against the CPU:
    a 64-particle subset of the dense configuration's P=1024 state at step
    40, Ackerman and CPHD at P=512 and the mixed bench at P=512. Requires
    a tiled merge among them."""
    base = SynthSLAMRunner(load_config(DENSE_CFG, {"n_particles": P_DENSE}),
                           DENSE_DATA, device=dev)
    for n in range(40):
        base.step(n)
    idx = torch.arange(0, P_DENSE, P_DENSE // P_DENSE_STEP, device=dev)
    gm = base.state.map_static
    r = SynthSLAMRunner(load_config(DENSE_CFG, dict(
        TILED, n_particles=P_DENSE_STEP)), DENSE_DATA, device=dev)
    r.state = base.state.replace(
        pose=base.state.pose[idx], log_weight=base.state.log_weight[idx],
        map_static=GMState(mean=gm.mean[idx], cov=gm.cov[idx],
                           weight=gm.weight[idx]),
        resample_idx=base.state.resample_idx[idx])
    choices = tile_step(dev, f"dense {P_DENSE_STEP} of P={P_DENSE}", r,
                        advance=False)
    for label, cfg_path in (("ackerman", CFG), ("cphd", CPHD_CFG)):
        choices += tile_step(dev, f"{label} P={P_MAIN}", SynthSLAMRunner(
            load_config(cfg_path, dict(TILED, n_particles=P_MAIN)), DATA,
            device=dev))
    z, mask = mixed_scans(MIXED_STEPS)
    choices += tile_step(dev, f"mixed P={P_MAIN}", ScanRunner(
        dataclasses.replace(mixed_cfg(P_MAIN), **TILED), z, mask, MIXED_DT,
        device=dev))
    require(any(ct for _, ct in choices), "tiles: no step merged on tiled "
            "rows")


def tiles_in_turns(dev, label, cfg_path, P):
    """evaluate_dataset untiled, then tiled at P particles (the whole
    dataset), launch counts and choices set to 0 just before each
    run and read just after: steps/s, ATE, OSPA, merge2d and gather_cols
    launches, the tiled merges (one merge2d launch on [4 P, 7, ct] rows
    and one gather_cols launch each) and the untiled fallbacks. Fails on
    NaN, ATE > ATE_LIMIT or a tiled run with no tiled merge. Returns the
    tiled runs' launches of the tiled merge."""
    rates = collections.defaultdict(list)
    tiled_launches = 0
    for tag in ("untiled", "tiled"):
        over = dict(TILED if tag == "tiled" else {}, n_particles=P)
        build.reset_launch_counts()
        with tile_choices() as got:
            res = evaluate_dataset(cfg_path, ".", overrides=over, device=dev)
        counts = dict(build.launch_counts)
        run = clean(res["run"], f"tiles {label} {tag}")
        require(np.isfinite(run["est_poses"]).all(),
                f"tiles {label} {tag}: NaN in the poses")
        require(res["mean_pose_err"] <= ATE_LIMIT,
                f"tiles {label} {tag}: mean ATE {res['mean_pose_err']:.4f} "
                f"m > {ATE_LIMIT} m")
        n_tiled = sum(1 for _, ct in got if ct)
        fallback = sum(1 for N, ct in got if not ct and N >= 256)
        widths = collections.Counter(ct for _, ct in got if ct)
        if tag == "tiled":
            require(n_tiled > 0, f"tiles {label}: merge2d never launched on "
                    "tiled rows")
            tiled_launches = n_tiled
        rates[tag].append(res["steps_per_s"])
        phase("tiles", f"{label} {cfg_path} P={P} {tag}: "
              f"{res['steps_per_s']:.2f} steps/s ({run['wall_s']:.3f} s), "
              f"mean ATE {res['mean_pose_err']:.4f} m, mean OSPA(1, 5) "
              f"{res['mean_ospa']:.4f}, overflow {run['overflow']}; merge2d "
              f"{counts.get('merge2d', 0)} launches ({n_tiled} on tiled rows, "
              f"tile row widths {dict(widths)}), gather_cols "
              f"{counts.get('gather_cols', 0)}; untiled fallback (a tile "
              f"above its widest row) on {fallback} steps, candidate width "
              f"below 256 on {len(got) - n_tiled - fallback}")
    t, u = rates["tiled"][0], rates["untiled"][0]
    phase("tiles", f"{label} P={P}: tiled {t:.2f} steps/s, untiled {u:.2f} "
          f"(one run each), ratio {t / u:.3f}")
    return tiled_launches


def capture_tiled(dev):
    """The dense configuration at P=1024 with tiles on, stepped to step
    TILE_CAPTURE: the arguments of that step's tiled merge (or the first
    later step's) and the step."""
    r = SynthSLAMRunner(load_config(DENSE_CFG, dict(
        TILED, n_particles=P_DENSE)), DENSE_DATA, device=dev)
    got = []
    armed = [False]

    def keep(i, args, kwargs):
        if armed[0] and not got:
            got.append([x.clone() if torch.is_tensor(x) else
                        tuple(t.clone() for t in x)
                        if isinstance(x, tuple) else x for x in args])
    n = 0
    with spy_on(phd_filter, "tiled_merge_packed", keep):
        while not got:
            require(n < r.n_steps, "tiles: the dense run never tiled after "
                    f"step {TILE_CAPTURE}")
            armed[0] = n >= TILE_CAPTURE
            r.step(n)
            n += 1
    return got[0], n - 1


def tiled_kernels(dev, errs):
    """The tiled merge's two launches on the captured dense inputs
    (:func:`capture_tiled`): the tile extraction (gather_cols) bit for bit
    its twin, merge2d on the [4096, 7, ct] tile rows against its twin
    (:func:`check_merge_rows`); errs takes the largest error. Returns
    time_kernels rows for both ("gather_cols tiled captured", "merge2d
    tiled captured")."""
    (packed, layout, ct, sep, out_cap), step = capture_tiled(dev)
    P, C, N = packed.shape
    idx, _ = tgm.tile_index(layout, ct, N)
    rows = tgm.tile_rows(packed, layout, ct)
    want_rows = tgm.tile_rows(packed.cpu(), tuple(x.cpu() for x in layout),
                              ct)
    require(torch.equal(rows.cpu(), want_rows),
            "tiles: the tile extraction differs from the twin")
    oc = out_cap // tgm.TILES
    got = merge_out(merge2d(rows, sep, oc), 2)
    want = merge_out(merge2d_reference(rows.cpu(), sep, oc), 2)
    flips, err = check_merge_rows(got, want, rows, sep, "merge2d tiled")
    errs["merge2d"] = max(errs["merge2d"], err)
    counts = layout[1]
    phase("tiles", f"dense P={P} step {step} captured: planes [{P}, {C}, "
          f"{N}] -> tile rows {list(rows.shape)} (ct {ct}; live lanes a "
          f"tile: mean {float(counts.float().mean()):.1f}, max "
          f"{int(counts.max())}); gather_cols bit-equal to its twin; merge2d "
          f"(out_cap {oc}) against its twin max |err| {err:.3g} (rtol 1e-4, "
          f"atol 1e-5), {len(flips)} rows parted at a lane on the merge "
          "threshold")
    sets = [(idx, packed)]
    return {
        "gather_cols tiled captured": (
            lambda: gather_cols(idx, packed),
            lambda: gather_cols_reference(idx, packed), 2,
            cycling(lambda i, t: torch.gather(
                t, 2, i.long()[:, None].expand(P, C, i.shape[1])), sets),
            (gather_bound(idx, C, N), "bytes")),
        "merge2d tiled captured": (
            lambda: merge2d(rows, sep, oc),
            lambda: merge2d_reference(rows, sep, oc), 1, None,
            merge_bound(rows, oc, 8, 27)),
    }


def run_tiles(dev, errs):
    """The spatially tiled merge (merge_spatial_tiles = 4): its kernels on
    captured dense inputs against their twins, one step of each path with
    tiles on against the CPU, data/ackerman at P=512 and data/dense at
    P=1024 untiled then tiled, and the Ackerman P=128 seeds 0-4
    beside the JAX package's CPU runs with tiles (and its untiled ones).
    Returns time_kernels rows (:func:`tiled_kernels`)."""
    t = [time.perf_counter()]

    def lap():
        t.append(time.perf_counter())
        return t[-1] - t[-2]
    rows = tiled_kernels(dev, errs)
    parts = {"kernels": lap()}
    tile_steps(dev)
    parts["steps against the CPU"] = lap()
    tiles_in_turns(dev, "ackerman", CFG, P_MAIN)
    tiles_in_turns(dev, "dense", DENSE_CFG, P_DENSE)
    parts["runs"] = lap()
    band = seed_band(dev, "tiled", CFG, TILED, TILED_CPU_BAND)
    band_line(f"tiled P={P_BAND} seeds {list(BAND_SEEDS)} beside the JAX "
              "package's untiled CPU runs", band, PLAIN_CPU_BAND)
    parts["band"] = lap()
    phase("tiles", f"{t[-1] - t[0]:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return rows


# ----------------------------------------------------------------------------
# the staged wide-lane kernels (phase "wide")
# ----------------------------------------------------------------------------

P_WIDE = 64                     # particles of the random wide merge cases
WIDE_STEPS = 30                 # steps of the dynamic-only and dense runs
WIDE_CAPTURE = 20               # the dense full grid's merge call and the
                                # consolidating K=2048 run's detect call
                                # captured
P_DENSE_CAPTURED = 8            # its particles held against the twin
MIXED_CAPTURE = 40              # the mixed full grid's step against the CPU
# the dense wide runs' mean ATE (m) and OSPA(1, 5) over WIDE_STEPS steps
# with the first design of the staged kernels (H100 80GB HBM3, 700 W)
FIRST_DENSE_WIDE = {"full grid": (0.1152, 1.4202), "K=2048": (0.0938, 1.4037)}
# the mixed bench with both caps off: the per-particle route over the full
# grid, 128 + 32 * 128 + 32 = 4256 lanes a map
MIXED_FULL = {"merge_candidate_cap": 0, "merge_candidate_cap_dynamic": 0}
DYN_FULL = {"feature_model": 1, "merge_candidate_cap": 0}
DENSE_FULL = {"merge_candidate_cap": 0}
DENSE_K2048 = {"max_features": 2048}    # tools/dense_k_sweep.py's override
MIXED_FULL_KERNELS = ("merge2d_argmax", "merge4d_argmax_wide")
DYN_FULL_KERNELS = ("merge4d_argmax_wide",)
DENSE_FULL_KERNELS = ("merge2d_argmax_wide",)
# t_k at K = 2048 (128 KB a particle) exceeds the gathers' shared budget
DENSE_K2048_KERNELS = ("detect_wide", "gather_cols", "gather_cols_ldg",
                       "merge2d")
# dense K = 2048 with the dense K = 1024 consolidating + adaptive run's knobs
DENSE_K2048_CONS = dict(DENSE_K2048, **DENSE_VARIANTS[
    "consolidating + adaptive"])
DENSE_K2048_CONS_KERNELS = ("detect_cons_adaptive_wide", "gather_cols",
                            "gather_cols_ldg", "merge2d")


def wide_merge_case(errs, label, name, fn, twin, packed, sep, metric):
    """One staged merge launch, counted under ``name``, against its twin
    with check_kernels' gates (:func:`check_merge_rows`: equal counts,
    rtol 1e-4 / atol 1e-5, a row parting only at a lane on the merge
    threshold). ``packed``: the planes the twin merges. Returns the
    largest |difference|."""
    D = MERGE_DIMS[packed.shape[1]]
    build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launched = dict(build.launch_counts)
    require(launched == {name: 1}, f"{label}: launched {launched}, not "
            f"{name}")
    got = merge_out(out, D)
    want = [x.cpu() for x in merge_out(twin(), D)]
    flips, err = check_merge_rows(got, want, packed, sep, label, metric)
    errs[name] = max(errs.get(name, 0.0), err)
    phase("wide", f"{label}: {name} clusters/particle "
          f"{float(got[3].float().mean()):.1f}, left "
          f"{float(got[4].float().mean()):.1f}, max |err| {err:.3g} (rtol "
          f"1e-4, atol 1e-5), {len(flips)} of {packed.shape[0]} rows part at "
          "a lane on the merge threshold")
    return err


def staged_beside_narrow(label, narrow, staged, D):
    """The staged variant forced at the narrow kernel's limit beside the
    narrow kernel: the same clusters and counts required, the sums to rtol
    1e-4 / atol 1e-5 (another order); whether the bits are equal is
    reported."""
    a, b = merge_out(narrow(), D), merge_out(staged(), D)
    require(torch.equal(a[3], b[3]) and torch.equal(a[4], b[4]),
            f"{label}: the staged variant's clusters differ from the narrow "
            "kernel's")
    for x, y in zip(a[:3], b[:3]):
        torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-5)
    phase("wide", f"{label}: staged beside narrow, counts equal, max |diff| "
          f"{max_err(list(zip(b[:3], a[:3]))):.3g}, bits "
          f"{'equal' if same_bits(a[:3], b[:3]) else 'differ'}")


def wide_merges(dev, errs, mixed_planes, dense_planes):
    """Every staged merge variant against its twin at widths its narrow
    kernel cannot hold, and forced at the narrow limit beside the narrow
    kernel: merge2d in its four variants at N = 8448 (sorted on weight-
    sorted clustered lanes, argmax on full-grid lanes), merge2d's argmax
    mode on the captured dense full-grid step (the whole launch, its twin
    on the lanes that enter, and P_DENSE_CAPTURED particles alone),
    merge2d_tables at N = 8448 (merge_bench.WIDE_EDGES), merge3d
    at N = 2400 and merge4d (sorted, argmax, Hellinger) on the captured
    mixed full-grid step (N = 4256). Returns time_kernels' rows."""
    rows = {}
    N2 = NARROW_LANES[2] + 256
    for sorted_w in (True, False):
        packed = (merge_inputs if sorted_w else full_grid_inputs)(
            dev, P=P_WIDE, N=N2, seed=N2)
        limit = packed[:, :, :NARROW_LANES[2]].contiguous()
        for metric in (0, 1):
            name = merge2d_variant(sorted_w, metric, wide=True)
            sep = HELL_SEP if metric else MIN_SEP
            call = (lambda p, s=sep, sw=sorted_w, m=metric, **kw:
                    merge2d(p, s, 128, sw, m, **kw))
            wide_merge_case(errs, f"merge2d P={P_WIDE} N={N2}", name,
                            lambda c=call, p=packed: c(p),
                            lambda p=packed, s=sep, sw=sorted_w, m=metric:
                            merge2d_reference(p, s, 128, sw, m), packed, sep,
                            metric)
            staged_beside_narrow(f"{name} at N={NARROW_LANES[2]}",
                                 lambda c=call: c(limit),
                                 lambda c=call: c(limit, wide=True), 2)
            if name != "merge2d_argmax_wide":
                rows[name] = (lambda c=call, p=packed: c(p),
                              lambda p=packed, s=sep, sw=sorted_w, m=metric:
                              merge2d_reference(p, s, 128, sw, m), 1, None,
                              merge_bound(packed, 128, 8,
                                          40 if metric else 27))
    # the dense full grid's captured launch: the whole of it (the path's
    # plan) against the twin on the lanes that enter
    # (merge_bench.entering_planes: the same output), then
    # P_DENSE_CAPTURED of its particles alone against the twin on all
    # their lanes (another plan)
    packed, sep, K = dense_planes
    name = merge2d_variant(False, 0, wide=True)
    entering = entering_planes(packed)
    # the kernels line's max |err|: the timed launch's
    errs[name] = wide_merge_case(
        {}, f"merge2d dense full grid captured P={packed.shape[0]} N="
        f"{packed.shape[2]} K={K}", name,
        lambda: merge2d(packed, sep, K, False),
        lambda: merge2d_reference(entering, sep, K, False), entering, sep, 0)
    sub = packed[:P_DENSE_CAPTURED].contiguous()
    wide_merge_case({}, f"merge2d dense full grid captured P="
                    f"{sub.shape[0]} N={sub.shape[2]} K={K}", name,
                    lambda: merge2d(sub, sep, K, False),
                    lambda: merge2d_reference(sub, sep, K, False), sub, sep,
                    0)
    enter = (packed[:, 1] > 0.5).sum(dim=1).float()
    plan = merge2d_plan(packed.shape[0], packed.shape[2], False, device=dev)
    phase("wide", f"dense full grid captured P={packed.shape[0]}: entering "
          f"lanes a particle mean {float(enter.mean()):.1f}, max "
          f"{int(enter.max())} of {packed.shape[2]}; {name} plan "
          f"{json.dumps(plan)}")
    rows[name] = (lambda: merge2d(packed, sep, K, False),
                  lambda: merge2d_reference(entering, sep, K, False), 1,
                  None, merge_bound(packed, K, 8, 27))
    for metric in (0, 1):
        sep = HELL_SEP if metric else MIN_SEP
        name = merge2d_variant(True, metric, tables=True, wide=True)
        for case, wide in (("N 8448", None), ("N 8192", True)):
            *tabs, K = tables_edge_case(case)
            tabs = tuple(torch.from_numpy(x).to(dev) for x in tabs)
            call = (lambda t=tabs, s=sep, k=K, m=metric, **kw:
                    merge2d_tables(*t, s, k, m, **kw))
            twin = (lambda t=tabs, s=sep, k=K, m=metric:
                    merge2d_tables_reference(*t, s, k, m))
            if wide:
                staged_beside_narrow(f"{name} at {case}", call,
                                     lambda c=call: c(wide=True), 2)
                continue
            wide_merge_case(errs, f"merge2d_tables {case} P="
                            f"{tabs[0].shape[0]}", name, call, twin,
                            tables_packed(*tabs), sep, metric)
            rows[name] = (call, twin, 1, None,
                          tables_bound(tabs[0], tabs[1], K,
                                       40 if metric else 27))
    N3 = 2400
    packed3 = merge3d_inputs(dev, P=P_WIDE, N=N3, seed=N3)
    for metric in (0, 1):
        sep = HELL_SEP if metric else DISP_SEP
        name = merge2d_variant(True, metric, D=3, wide=True)
        call = (lambda p, s=sep, m=metric, **kw: merge3d(p, s, 64, m, **kw))
        twin = (lambda p=packed3, s=sep, m=metric:
                merge3d_reference(p, s, 64, m))
        wide_merge_case(errs, f"merge3d P={P_WIDE} N={N3}", name,
                        lambda c=call: c(packed3), twin, packed3, sep, metric)
        limit = packed3[:, :, :NARROW_LANES[3]].contiguous()
        staged_beside_narrow(f"{name} at N={NARROW_LANES[3]}",
                             lambda c=call: c(limit),
                             lambda c=call: c(limit, wide=True), 3)
        rows[name] = (lambda c=call: c(packed3), twin, 1, None,
                      merge_bound(packed3, 64, 12, 70))
    # the mixed full grid's dynamic map, in its lane order (argmax) and
    # weight-sorted (sorted mode, Hellinger)
    packed4, _, K4 = mixed_planes
    sorted4 = sort_planes(packed4, 4).contiguous()
    for sorted_w, metric in ((True, 0), (False, 0), (True, 1)):
        planes = sorted4 if sorted_w else packed4
        sep = HELL_SEP if metric else MIXED_SEP
        name = merge2d_variant(sorted_w, metric, D=4, wide=True)
        call = (lambda p, s=sep, sw=sorted_w, m=metric, **kw:
                merge4d(p, s, K4, sw, m, **kw))
        twin = (lambda p=planes, s=sep, sw=sorted_w, m=metric:
                merge4d_reference(p, s, K4, sw, m))
        wide_merge_case(errs, f"merge4d mixed full grid captured P="
                        f"{planes.shape[0]} N={planes.shape[2]}", name,
                        lambda c=call, p=planes: c(p), twin, planes, sep,
                        metric)
        if not sorted_w:
            enter = (planes[:, 1] > 0.5).sum(dim=1).float()
            phase("wide", f"mixed full grid captured P={planes.shape[0]}: "
                  f"entering lanes a particle mean "
                  f"{float(enter.mean()):.1f}, max {int(enter.max())} of "
                  f"{planes.shape[2]}; {name} plan " + json.dumps(merge_plan(
                      4, planes.shape[0], planes.shape[2], dev, False)))
        limit = planes[:, :, :NARROW_LANES[4]].contiguous()
        staged_beside_narrow(f"{name} at N={NARROW_LANES[4]}",
                             lambda c=call: c(limit),
                             lambda c=call: c(limit, wide=True), 4)
        rows[name] = (lambda c=call, p=planes: c(p), twin, 1, None,
                      merge_bound(planes, K4, 16, 120))
    return rows


def wide_detects(dev, errs):
    """The detect variants above 1024 features: all four modes at the dense
    shape with K = 2048 (P = 1024, M = 72, T = 32) against the twin, the
    wide variant forced at detect_bench.DETECT_EDGES, and forced at
    K = 1024 beside the narrow kernel (the same bits expected: the same
    pdw, normalizer order and selection). Returns time_kernels' rows."""
    rows = {}
    cfg = load_config(DENSE_CFG)
    min_fw, cb = cfg.min_feature_weight, cfg.clutter_density + cfg.birth_weight
    scenes = {K: map_scene(cfg, P_DENSE, K, 72, 65, 0, dev)
              for K in (NARROW_FEATURES, 2 * NARROW_FEATURES)}
    for cons in (False, True):
        planes = {K: detect_planes(cfg, s, consolidate=cons)
                  for K, s in scenes.items()}
        for adaptive in (False, True):
            sep = cfg.min_separation if cons else 0.0
            a = (*planes[2 * NARROW_FEATURES], 32, min_fw, cb, sep, adaptive)
            got, name, err, flips = check_case(
                f"dense K={2 * NARROW_FEATURES}", a)
            errs[name] = max(errs.get(name, 0.0), err)
            stats = live_counts(got[3], a[1], 32)
            plan = "; plan " + json.dumps(detect_wide_plan(
                2 * NARROW_FEATURES, dev, M=72 if cons else None))
            phase("wide", f"{name} P={P_DENSE} K={2 * NARROW_FEATURES} M=72 "
                  f"T=32: live lanes per valid row {json.dumps(stats)}; "
                  f"against the twin max |err| {err:.3g}, {flips} member "
                  f"flips at an f32 boundary{plan}")
            rows[name] = (lambda a=a: detect(*a),
                          lambda a=a: detect_reference(*a), 1, None,
                          detect_bound(*a[:6]))
            b = (*planes[NARROW_FEATURES], 32, min_fw, cb, sep, adaptive)
            narrow, staged = detect(*b), detect(*b, wide=True)
            require(all(torch.equal(x, y) for x, y in
                        zip(narrow[1:4:2], staged[1:4:2])),
                    f"{name} at K={NARROW_FEATURES}: idx or counts differ "
                    "from the narrow kernel's")
            for x, y in zip(narrow, staged):
                if x.dtype == torch.float32:
                    torch.testing.assert_close(y, x, rtol=1e-5, atol=0)
            phase("wide", f"{name} at K={NARROW_FEATURES} beside the narrow "
                  f"kernel: idx and counts equal, bits "
                  f"{'equal' if same_bits(narrow, staged) else 'differ'}")
    n = 0
    for case in DETECT_EDGES:
        for cons in (False, True):
            planes, z4, T, min_fw, cb = (
                torch.from_numpy(x).to(dev) if isinstance(x, np.ndarray)
                else x for x in detect_edge_case(case, cons))
            for adaptive in (False, True):
                a = (planes, z4, T, min_fw, cb,
                     MIN_SEP_EDGES if cons else 0.0, adaptive)
                _, name, err, _ = check_case(f"edge {case}", a, wide=True)
                errs[name] = max(errs.get(name, 0.0), err)
                n += 1
    phase("wide", f"detect edges: {len(DETECT_EDGES)} cases, {n} wide "
          "launches against the twin")
    return rows


def spy_on(module, name, keep):
    """A mock.patch of module.name that hands each call's arguments to
    ``keep`` (call number, args, kwargs) before calling the wrapper."""
    real = getattr(module, name)
    calls = [0]

    def call(*args, **kwargs):
        keep(calls[0], args, kwargs)
        calls[0] += 1
        return real(*args, **kwargs)
    return mock.patch.object(module, name, call)


def run_mixed_full(dev, capped):
    """The mixed full grid: the mixed bench (P=512, K=128, M=32) with both
    candidate caps off (the per-particle route, 4256 lanes a map; the
    dynamic map through merge4d_argmax_wide). Step MIXED_CAPTURE against
    the CPU twins (:func:`step_against_cpu`), its merge4d input captured;
    then the 100 scans, finite, beside the capped per-particle route's
    steps/s in this call (``capped``). Returns (counts, captured planes,
    sep, K)."""
    r = slow_runner(dev, **MIXED_FULL)
    require(not mixed_filter.uses_fast_route(r.cfg, 128, 32),
            "mixed full grid: the configuration takes the fast route")
    for n in range(MIXED_CAPTURE):
        r.step(n)
    got = []

    def keep(i, args, kw):
        if not got and args[0].is_cuda:
            got.append((args[0].clone(), *args[1:3]))
    with spy_on(phd_filter, "merge4d", keep):
        err, _, n_edge, n_swap = step_against_cpu(r, MIXED_CAPTURE)
    require(bool(got), "mixed full grid: no merge4d call captured")
    phase("wide", f"mixed full grid step {MIXED_CAPTURE} at P={P_MAIN}: card "
          f"vs CPU twins max |err| {err:.3g} (rtol 1e-4, atol 1e-5), "
          f"overflow equal; {n_swap} weight-tied slots swapped, {n_edge} "
          "resampling strata at a cumulative-weight boundary")
    r = slow_runner(dev, **MIXED_FULL)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = clean(r.run(), "mixed full grid")
    counts = dict(build.launch_counts)
    require(np.isfinite(res["est_poses"]).all()
            and np.isfinite(res["n_eff"]).all(), "mixed full grid: NaN")
    require(all(counts.get(k, 0) > 0 for k in MIXED_FULL_KERNELS),
            f"mixed full grid: a kernel of the path never launched: {counts}")
    phase("wide", f"mixed full grid P={P_MAIN} K=128 M=32 (4256 lanes a "
          f"map), {SLOW_STEPS} steps: {res['steps_per_s']:.2f} steps/s "
          f"({res['wall_s']:.3f} s; the capped per-particle route in this "
          f"call {capped['steps_per_s']:.2f}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, overflow "
          f"{res['overflow']}, final nEff {res['n_eff'][-1]:.3f}")
    phase("wide", "launches: " + ", ".join(
        f"{k}={counts.get(k, 0)}" for k in KERNELS if counts.get(k, 0)))
    return counts, got[0]


def run_dynamic_full(dev):
    """The dynamic-only map's full grid (cfg/ackerman.cfg, feature_model 1,
    cap 0: 128 + 48 * 128 + 48 = 6320 4D lanes a particle, through
    merge4d_argmax_wide) over WIDE_STEPS steps of data/ackerman at P=512:
    finite, its kernels launched, steps/s and peak memory (the static
    scorer of evaluate_dataset has no 4D map to score). Returns the launch
    counts."""
    cfg = load_config(CFG, dict(DYN_FULL, n_particles=P_MAIN,
                                n_steps=WIDE_STEPS))
    r = SynthSLAMRunner(cfg, DATA, device=dev)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = clean(r.run(), "dynamic-only full grid")
    counts = dict(build.launch_counts)
    require(np.isfinite(res["est_poses"]).all()
            and np.isfinite(res["n_eff"]).all(), "dynamic-only full grid: NaN")
    require(all(counts.get(k, 0) > 0 for k in DYN_FULL_KERNELS),
            f"dynamic-only full grid: a kernel never launched: {counts}")
    live = float((r.state.map_dynamic.weight > 0).sum(1).float().mean())
    phase("wide", f"dynamic-only full grid {CFG} P={P_MAIN} (6320 4D lanes), "
          f"{WIDE_STEPS} steps: {res['steps_per_s']:.2f} steps/s "
          f"({res['wall_s']:.3f} s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, overflow "
          f"{res['overflow']}, final nEff {res['n_eff'][-1]:.3f}, mean live "
          f"dynamic components {live:.1f}")
    phase("wide", "launches: " + ", ".join(
        f"{k}={counts.get(k, 0)}" for k in KERNELS if counts.get(k, 0)))
    return counts


def run_dense_wide(dev, errs):
    """The dense configuration's wide paths over WIDE_STEPS steps at
    P=1024: the full grid (cap 0: 1024 + 72 * 1024 + 72 = 74 824 lanes a
    particle, merge2d_argmax_wide; its merge input captured at call
    WIDE_CAPTURE) beside the capped run's ATE and OSPA over the same
    steps, K = 2048 (detect_wide) beside K = 1024, and K = 2048
    consolidating + adaptive (detect_cons_adaptive_wide on every step the
    plain K = 2048 run detects; its detect call WIDE_CAPTURE captured, the
    whole launch held against the twin under compare_detect's gates)
    beside the plain K = 2048 run. Returns (full-grid counts, K = 2048
    counts, consolidating K = 2048 counts, captured merge (planes, sep,
    K), time_kernels' row of the captured detect call)."""
    got = []

    def keep(i, args, kw):
        if i == WIDE_CAPTURE:
            got.append((args[0].clone(), *args[1:3]))
    with spy_on(phd_filter, "merge2d", keep):
        full_counts, full = run_path(dev, "wide", DENSE_CFG, DENSE_FULL,
                                     DENSE_FULL_KERNELS, n_steps=WIDE_STEPS,
                                     P=P_DENSE)
    require(bool(got), "dense full grid: no merge2d call captured")
    _, capped = run_path(dev, "wide", DENSE_CFG, {}, ACKERMAN_KERNELS,
                         n_steps=WIDE_STEPS, P=P_DENSE)
    k_counts, k2048 = run_path(dev, "wide", DENSE_CFG, DENSE_K2048,
                               DENSE_K2048_KERNELS, n_steps=WIDE_STEPS,
                               P=P_DENSE)
    det = []

    def keep_detect(i, args, kw):
        if i == WIDE_CAPTURE:
            det.append(captured_args((
                tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                kw)))
    with spy_on(phd_filter, "detect", keep_detect):
        cons_counts, cons = run_path(dev, "wide", DENSE_CFG, DENSE_K2048_CONS,
                                     DENSE_K2048_CONS_KERNELS,
                                     n_steps=WIDE_STEPS, P=P_DENSE)
    require(bool(det), "dense K=2048 consolidating: no detect call captured")
    for label, res in (("full grid", full), ("K=2048", k2048)):
        clean(res["run"], f"dense {label}")
        ate0, ospa0 = FIRST_DENSE_WIDE[label]
        phase("wide", f"dense {label} P={P_DENSE}, {WIDE_STEPS} steps: mean "
              f"ATE {res['mean_pose_err']:.4f} m, OSPA "
              f"{res['mean_ospa']:.4f} (the first staged kernels: "
              f"{ate0} m, {ospa0}), {res['steps_per_s']:.2f} steps/s, "
              f"beside the capped K=1024 run over the same steps: "
              f"{capped['mean_pose_err']:.4f} m, {capped['mean_ospa']:.4f}, "
              f"{capped['steps_per_s']:.2f} steps/s")
        require(res["mean_pose_err"] <= ATE_LIMIT,
                f"dense {label}: mean ATE {res['mean_pose_err']:.4f} m > "
                f"{ATE_LIMIT} m")
    clean(cons["run"], "dense K=2048 consolidating + adaptive")
    name = DENSE_K2048_CONS_KERNELS[0]
    phase("wide", f"dense K=2048 consolidating + adaptive P={P_DENSE}, "
          f"{WIDE_STEPS} steps: {name} {cons_counts.get(name, 0)} launches "
          f"(the plain K=2048 run's detect_wide: "
          f"{k_counts.get('detect_wide', 0)}), mean ATE "
          f"{cons['mean_pose_err']:.4f} m, OSPA {cons['mean_ospa']:.4f}, "
          f"{cons['steps_per_s']:.2f} steps/s, beside the plain K=2048 run "
          f"over the same steps: {k2048['mean_pose_err']:.4f} m, "
          f"{k2048['mean_ospa']:.4f}, {k2048['steps_per_s']:.2f} steps/s")
    require(cons_counts.get(name, 0) == k_counts.get("detect_wide", 0),
            f"dense K=2048 consolidating: {name} launched "
            f"{cons_counts.get(name, 0)} times, not on each of the "
            f"{k_counts.get('detect_wide', 0)} steps the plain run detects")
    require(cons["mean_pose_err"] <= ATE_LIMIT,
            f"dense K=2048 consolidating: mean ATE "
            f"{cons['mean_pose_err']:.4f} m > {ATE_LIMIT} m")
    a = det[0]
    planes, z4, T = a[:3]
    got_det, launched, err, flips = check_case(
        f"dense K=2048 consolidating + adaptive call {WIDE_CAPTURE}", a)
    require(launched == name, f"captured detect launched {launched}")
    errs[name] = max(errs.get(name, 0.0), err)
    phase("wide", f"dense K=2048 consolidating + adaptive, detect call "
          f"{WIDE_CAPTURE} captured: {name} P={planes.shape[0]} "
          f"K={planes.shape[2]} M={z4.shape[0]} T={T}, the whole launch "
          f"against the twin: max |err| {err:.3g}, {flips} member flips at "
          f"an f32 boundary; live lanes per valid row "
          f"{json.dumps(live_counts(got_det[3], z4, T))}")
    row = {f"{name} captured": (lambda a=a: detect(*a),
                                lambda a=a: detect_reference(*a), 1, None,
                                detect_bound(*a[:6]))}
    return full_counts, k_counts, cons_counts, got[0], row


def run_wide(dev, errs, capped_mixed):
    """The staged wide-lane variants: the mixed full grid, the dynamic-only
    full grid (cfg/ackerman.cfg, feature_model 1, cap 0: 128 + 48 * 128 +
    48 = 6320 4D lanes) over WIDE_STEPS steps at P=512 and the dense wide
    paths, each finite and launching its wide kernels; then every staged
    variant against its twin and beside its narrow kernel
    (:func:`wide_merges`, :func:`wide_detects`). Returns (path counts,
    time_kernels' rows)."""
    t0 = time.perf_counter()
    mixed_counts, mixed_planes = run_mixed_full(dev, capped_mixed)
    dyn_counts = run_dynamic_full(dev)
    dense_counts, k_counts, cons_counts, dense_planes, cons_row = \
        run_dense_wide(dev, errs)
    rows = wide_merges(dev, errs, mixed_planes, dense_planes)
    rows.update(wide_detects(dev, errs))
    rows.update(cons_row)
    phase("wide", f"{time.perf_counter() - t0:.1f} s")
    return [(MIXED_FULL_KERNELS, mixed_counts), (DYN_FULL_KERNELS, dyn_counts),
            (DENSE_FULL_KERNELS, dense_counts),
            (DENSE_K2048_KERNELS, k_counts),
            (DENSE_K2048_CONS_KERNELS, cons_counts)], rows


# ----------------------------------------------------------------------------
# the multi-process runtime (phdslam_tpu_torch/parallel): one NCCL rank,
# then Gloo ranks sharing the card
# ----------------------------------------------------------------------------

PAR_LOCKSTEP = 60               # gloo4's gated steps at threshold 1.1
PAR_SHORT = 30                  # mixed4, cphd4 and eap4
PAR_DISP_FRAMES = 20
PAR_CKPT = (40, 80)             # saved by two ranks, resumed on four
PAR_FULL_STEPS = 10             # neighbor_migration 0: the full gather
PAR_TIMEOUT = 600


def par_group(n, task, backend, walls):
    """run_group on the card, its wall time (spawn to exit) kept."""
    t0 = time.perf_counter()
    out = run_group(n, task, device="cuda", backend=backend,
                    timeout_s=PAR_TIMEOUT)
    walls.append(f"{n} {backend} rank(s) {time.perf_counter() - t0:.1f} s")
    return out


def ack_task(kind, steps=None, cfg_path=CFG, **overrides):
    task = {"kind": kind, "runner": "synth", "cfg": cfg_path, "data": DATA,
            "overrides": dict(overrides, n_particles=P_MAIN)}
    return dict(task, steps=steps) if steps else task


def gated_phase(label, ranks, kernels):
    """One gated run on every rank: each sharded step within the step gates
    of the 1-process step on the same state and draws (sim.Gate), every
    kernel of the path launched by the sharded steps on every rank."""
    r = ranks[0]
    for k in kernels:
        require(all(x["launches"].get(k, 0) > 0 for x in ranks),
                f"{label}: {k} not launched on every rank: "
                f"{[x['launches'] for x in ranks]}")
    mig = r["migrations"]
    per = {k: r["migration_bytes"][k] / v for k, v in mig.items() if v}
    phase(label, f"{r['steps']} steps on {len(ranks)} ranks within the "
          f"step gates (rtol 1e-4, atol 1e-5), {r['bit_equal_steps']} "
          f"bit-equal to the 1-process step, {r['resyncs']} resyncs "
          f"({r['strata_moved']} strata at a cumulative-weight boundary), "
          f"{r['slots_swapped']} weight-tied slots swapped, max |diff| "
          f"{r['max_err']:.3g}; {r['resampled_steps']} resampling steps: "
          f"migrations {mig}, bytes a resampling step on rank 0 "
          + ", ".join(f"{k} {v:.0f}" for k, v in per.items())
          + f"; launches per rank "
          + "; ".join(", ".join(f"{k}={x['launches'].get(k, 0)}"
                                for k in kernels) for x in ranks)
          + "; transport per rank " + ", ".join(x["transport"] for x in ranks))


class OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Every PyTorch op of a call, in order: its name, the innermost line of
    the port that issued it, and clones of its tensor inputs and outputs
    (allocations and factories skipped: a kernel launched through ctypes
    fills the former unseen, the latter take the batch's size). Given ``ref`` (another call's log) and a block ``r`` of
    ``n``, each op is held instead to the reference op's rows of that
    block (:func:`block_rows`) and only whether its inputs and its outputs
    equal them, all and floating-point only, is kept."""
    SKIP = ("aten.empty", "aten.empty_like", "aten.empty_strided",
            "aten.new_empty", "aten.new_empty_strided")

    def __init__(self, ref=None, r=0, n=1):
        super().__init__()
        self.ops, self.ref, self.r, self.n = [], ref, r, n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import traceback
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if name in self.SKIP:
            return out
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        if not ins:             # a factory: its size is the batch's
            return out
        port = [f for f in traceback.extract_stack()
                if f"{os.sep}phdslam_tpu_torch{os.sep}" in f.filename]
        site = (f"{os.path.relpath(port[-1].filename)}:{port[-1].lineno}"
                if port else "?")
        if any(f.filename.endswith(os.path.join("ops", "resample.py"))
               for f in port):
            site += " (ops/resample.py)"
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if self.ref is None:
            self.ops.append((name, site, [a.detach().clone() for a in ins],
                             [o.detach().clone() for o in outs]))
            return out
        k = len(self.ops)
        if k >= len(self.ref) or self.ref[k][0] != name:
            self.ops.append((name, site, None, None, None, None))
            return out
        _, _, r_ins, r_outs = self.ref[k]
        self.ops.append((name, site, *(
            same_rows(a, b, self.r, self.n, floats)
            for a, b in ((r_ins, ins), (r_outs, outs))
            for floats in (False, True))))
        return out


def block_rows(big, small, r, n):
    """Block r of n of ``big`` along its particle axis (the one axis n
    times ``small``'s), ``big`` itself where the shapes agree, else None."""
    if big.shape == small.shape:
        return big
    for a in range(big.dim()):
        if big.dim() == small.dim() and big.shape[a] == n * small.shape[a] \
                and all(big.shape[i] == small.shape[i]
                        for i in range(big.dim()) if i != a):
            return big.narrow(a, r * small.shape[a], small.shape[a])
    return None


def same_rows(bigs, smalls, r, n, floats=False):
    """True when every tensor of ``smalls`` (``floats``: every floating-point
    one) equals block r of its ``bigs`` bit for bit (NaN equal to NaN),
    None when one has no such block."""
    if len(bigs) != len(smalls):
        return None
    for b, s in zip(bigs, smalls):
        if floats and not s.dtype.is_floating_point:
            continue
        b = block_rows(b, s, r, n)
        if b is None:
            return None
        if b.dtype.is_floating_point:
            if not bool(((b == s) | (b.isnan() & s.isnan())).all()):
                return False
        elif not torch.equal(b, s):
            return False
    return True


def cphd_block_bits(dev, n_before=20, n=4):
    """Where a CPHD update's bits depend on the batch: the update of step
    n_before of cfg/ackerman_cphd.cfg at P=512 on the whole batch, then on
    each of n blocks of 128 rows of the same state (what a rank of
    ``[parallel cphd4]`` runs), every PyTorch op held to the batch's rows
    (:class:`OpLog`). An op whose outputs part while its inputs agree is
    where the bits part; the cross-particle reductions of
    ``ops/resample.py`` part by design (a block's own sum and maximum). An
    op whose floating-point inputs part before any op's outputs did reads
    what a kernel (launched through ctypes, unseen) wrote."""
    from phdslam_tpu_torch.parallel.sharding import map_leaves
    cfg = load_config(CPHD_CFG, {"n_particles": P_MAIN})
    r = SynthSLAMRunner(cfg, DATA, device=dev)
    for i in range(n_before):
        r.step(i)
    z, zm, ctl, dt, dp, has_z = r.step_args(n_before)
    require(has_z, f"parallel cphd bits: no measurements at {n_before}")
    noise = r.noise()
    st = phd_filter.predict(r.state, ctl, dt, cfg, noise.eps_pred) \
        if dp else r.state
    with OpLog() as big:
        phd_filter.update(st, z, zm, cfg, r.consts)
    b = P_MAIN // n
    origins, diverged, fed = {}, None, None
    for j in range(n):
        blk = map_leaves(st, lambda x: x[j * b:(j + 1) * b])
        with OpLog(big.ops, j, n) as small:
            phd_filter.update(blk, z, zm, cfg, r.consts)
        parted = False
        for k, (name, site, ins, ins_f, outs, outs_f) in enumerate(
                small.ops):
            if k >= len(big.ops) or big.ops[k][0] != name:
                diverged = min(k, diverged if diverged is not None else k)
                break
            if ins and outs is False:
                origins.setdefault((k, name, site), []).append(j)
            elif ins_f is False and not parted and fed is None:
                fed = (k, name, site)       # written unseen: a kernel's
            parted = parted or outs_f is False
    del big
    torch.cuda.empty_cache()
    cross = {o: v for o, v in origins.items()
             if o[2].endswith("(ops/resample.py)")}
    own = sorted(set(origins) - set(cross))
    first_fed = ("none" if fed is None else
                 f"op {fed[0]} {fed[1]} at {fed[2]}")
    phase("parallel cphd bits", f"CPHD update of step {n_before} at "
          f"P={P_MAIN} (data/ackerman) as one batch and as {n} blocks of "
          f"{b} rows, {len(small.ops)} PyTorch ops each held to the batch's "
          f"rows: ops whose outputs part while their inputs agree "
          + ("none" if not own else "; ".join(
              f"op {k} {name} at {site} (blocks {origins[(k, name, site)]})"
              for k, name, site in own[:6]))
          + f"; the cross-particle reductions (by design) "
          + (", ".join(sorted({f"{nm} at {st_}" for _, nm, st_ in cross}))
             or "none")
          + f"; the first op fed inputs that already part: {first_fed}"
          + ("" if diverged is None else
             f"; the op sequence diverges at op {diverged}"))


def run_parallel(dev, main_res):
    """The sharded runtime on the card through ``parallel/sim.py``: a world
    of one NCCL rank repeating run_main bit for bit; a 2-rank Gloo group
    saving a checkpoint; then one 4-rank Gloo group (block 128, the ranks
    sharing the card) running the Ackerman lockstep window, the full
    sequence twice, the mixed, CPHD, EAP and disparity windows and the
    checkpoint resumed."""
    t0 = time.perf_counter()
    walls = []
    ref = main_res["run"]
    r = par_group(1, dict(ack_task("run"), score=True), "nccl", walls)[0]
    a = r.pop("arrays")
    bits = {k: bool(np.array_equal(a[k], ref[k]))
            for k in ("est_poses", "n_eff", "resampled")}
    require(all(bits.values()), f"parallel nccl1: not bit-equal to run_main "
            f"{bits}, max pose |diff| "
            f"{float(np.abs(a['est_poses'] - ref['est_poses']).max()):.3g}")
    require(all(r["launches"].get(k, 0) > 0 for k in ACKERMAN_KERNELS),
            f"parallel nccl1: launches {r['launches']}")
    phase("parallel nccl1", f"data/ackerman P={P_MAIN}, {r['steps']} steps "
          f"on one NCCL rank: poses, nEff and resampling decisions "
          f"bit-equal to run_main; {r['steps_per_s']:.2f} steps/s (run_main "
          f"{main_res['steps_per_s']:.2f} in this call), mean ATE "
          f"{r['mean_pose_err']:.4f} m; launches "
          + ", ".join(f"{k}={r['launches'].get(k, 0)}"
                      for k in ACKERMAN_KERNELS)
          + f"; migrations {r['migrations']}; transport {r['transport']}")

    z_all, mask_all = mixed_scans(MIXED_STEPS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save, end = PAR_CKPT
        par_group(2, dict(ack_task("run", save), chunk=save, save=ckpt),
                  "gloo", walls)
        np.savez(os.path.join(tmp, "mixed.npz"), z_all=z_all[:PAR_SHORT],
                 mask_all=mask_all[:PAR_SHORT])
        tasks = {
            "gloo4": ack_task("gated", PAR_LOCKSTEP, resample_threshold=1.1),
            "gloo4 full gather": ack_task(
                "gated", PAR_FULL_STEPS, resample_threshold=1.1,
                neighbor_migration=0),
            "run": dict(ack_task("run"), score=True),
            "run again": dict(ack_task("run"), score=True,
                              collective_timing=True),
            "mixed4": {"kind": "gated", "runner": "scan", "dt": MIXED_DT,
                       "npz": os.path.join(tmp, "mixed.npz"),
                       "fields": dataclasses.asdict(mixed_cfg(P_MAIN)),
                       "steps": PAR_SHORT},
            "cphd4": ack_task("gated", PAR_SHORT, CPHD_CFG),
            "eap4": ack_task("gated", PAR_SHORT, **EAP),
            "disparity4": {"kind": "gated", "runner": "disparity",
                           "cfg": DISP_CFG, "data": DISP_DATA,
                           "overrides": {"n_particles": P_MAIN},
                           "steps": PAR_DISP_FRAMES},
            "ckpt": dict(ack_task("run", end), chunk=save, resume=os.path.join(
                ckpt, f"step{save:05d}")),
        }
        res = par_group(4, {"kind": "each", "tasks": list(tasks.values())},
                        "gloo", walls)
    out = {name: [x["results"][i] for x in res]
           for i, name in enumerate(tasks)}
    arrays = {name: {k[len(f"t{i}_"):]: v for k, v in res[0]["arrays"]
                     .items() if k.startswith(f"t{i}_")}
              for i, name in enumerate(tasks)}
    gated_phase("parallel gloo4", out["gloo4"], ACKERMAN_KERNELS)
    gated_phase("parallel gloo4", out["gloo4 full gather"], ACKERMAN_KERNELS)
    runs = [out["run"][0], out["run again"][0]]
    repeat = all(np.array_equal(arrays["run"][k], arrays["run again"][k])
                 for k in ("est_poses", "n_eff", "resampled"))
    require(repeat, "parallel gloo4: the repeated run's bits differ")
    ate = runs[0]["mean_pose_err"]
    require(ate <= ATE_LIMIT, f"parallel gloo4: mean ATE {ate:.4f} m > "
            f"{ATE_LIMIT} m")
    require(np.isfinite(arrays["run"]["est_poses"]).all(),
            "parallel gloo4: NaN poses")
    for x in out["run"]:
        require(all(x["launches"].get(k, 0) > 0 for k in ACKERMAN_KERNELS),
                f"parallel gloo4: rank launches {x['launches']}")
    timed = runs[1]
    coll_ms = sum(timed["collective_ms"].values()) / timed["steps"]
    mig = runs[0]["migrations"]
    lo, hi = ATE_BAND
    phase("parallel gloo4", f"data/ackerman P={P_MAIN} over "
          f"{runs[0]['steps']} steps on 4 Gloo ranks sharing the card: "
          f"{runs[0]['steps_per_s']:.2f} steps/s (run_main "
          f"{main_res['steps_per_s']:.2f}), mean ATE {ate:.4f} m (JAX band "
          f"{lo}-{hi} m; run_main {main_res['mean_pose_err']:.4f}), OSPA "
          f"{runs[0]['mean_ospa']:.4f}; the repeated run bit-equal; "
          f"migrations {mig}; collectives {coll_ms:.3f} ms a step on rank 0 "
          f"(synchronised, the peers' waits included: "
          + ", ".join(f"{k} {v / timed['steps']:.3f}"
                      for k, v in timed["collective_ms"].items())
          + f"), bytes a step from the other ranks "
          + ", ".join(f"{k} {v / timed['steps']:.0f}"
                      for k, v in timed["collective_bytes"].items())
          + "; launches per rank "
          + "; ".join(", ".join(f"{k}={x['launches'].get(k, 0)}"
                                for k in ACKERMAN_KERNELS)
                      for x in out["run"])
          + "; transport per rank "
          + ", ".join(x["transport"] for x in out["run"]))
    gated_phase("parallel mixed4", out["mixed4"], MIXED_KERNELS)
    gated_phase("parallel cphd4", out["cphd4"], CPHD_KERNELS)
    # every CPHD op's bits are the batch's whatever rows a rank holds
    # (kernels/cardinality.py: the cardinality product in one fixed order):
    # each sharded step repeats the 1-process step bit for bit
    cphd4 = out["cphd4"][0]
    require(cphd4["bit_equal_steps"] == cphd4["steps"],
            f"parallel cphd4: {cphd4['bit_equal_steps']} of "
            f"{cphd4['steps']} steps bit-equal to the 1-process step")
    cphd_block_bits(dev)
    gated_phase("parallel eap4", out["eap4"], ACKERMAN_KERNELS)
    gated_phase("parallel disparity4", out["disparity4"], DISP_KERNELS)

    cfg80 = load_config(CFG, {"n_particles": P_MAIN, "n_steps": end})
    want = SynthSLAMRunner(cfg80, DATA, device=dev).run(chunk=save)
    got = arrays["ckpt"]
    g, w = got["est_poses"][save:], want["est_poses"][save:]
    require(np.allclose(g, w, rtol=1e-4, atol=1e-5)
            and np.array_equal(got["resampled"][save:],
                               want["resampled"][save:]),
            f"parallel ckpt: steps {save}-{end - 1} outside the step gates "
            f"of the uninterrupted run, max pose |diff| "
            f"{float(np.abs(g - w).max()):.3g}")
    phase("parallel ckpt", f"saved at step {save} by 2 Gloo ranks, resumed "
          f"on 4 to step {end}: within the step gates of the uninterrupted "
          f"1-process run (rtol 1e-4, atol 1e-5; max pose |diff| "
          f"{float(np.abs(g - w).max()):.3g}, bit-equal "
          f"{bool(np.array_equal(g, w))})")
    phase("parallel", f"{time.perf_counter() - t0:.1f} s: groups "
          + ", ".join(walls) + "; the 4-rank tasks' loops "
          + ", ".join(f"{k} {v[0]['wall_s']:.1f} s" for k, v in out.items()))


def main():
    t_start = time.perf_counter()
    seconds = {}                    # each phase's wall time ([phases])
    time_phases(sys.modules[__name__], seconds)
    smi = check_device()
    dev = torch.device("cuda:0")
    build_kernels()
    errs = check_kernels(dev)
    check_variants(dev, errs)
    check_step(dev)
    check_step(dev, overrides=CONS)
    check_mixed_step(dev)
    check_mixed_slow_step(dev)
    check_disparity_step(dev)
    check_cphd_step(dev)
    check_dense_steps(dev)
    check_estimator_steps(dev)
    counts, main_res = run_main(dev)
    run_runtime(dev, main_res)
    run_parallel(dev, main_res)
    knob_counts, cons_counts = run_knobs(dev, main_res)
    run_eap(dev, main_res, counts)
    time_eap(dev)
    run_variance(dev, main_res)
    run_shotgun(dev)
    run_topk(dev)
    run_scheme2(dev)
    run_scale(dev)
    mixed_counts, mixed_res = run_mixed(dev)
    slow_counts, slow_res = run_mixed_slow(dev, mixed_res)
    mixed_accuracy(dev)
    mixed_hell_counts = mixed_option_accuracy(dev)
    disp_counts = run_disparity_data(dev)
    disparity_bench(dev)
    disparity_accuracy(dev)
    disparity_one_point(dev)
    cphd_counts, cphd_res = run_cphd(dev)
    grid_counts, cphd_full_res = run_full_grid(
        dev, {CFG: main_res["mean_pose_err"],
              CPHD_CFG: cphd_res["mean_pose_err"]})
    cphd_route_seeds(dev, {"det": cphd_res, "full grid": cphd_full_res})
    disp_hell_counts = run_options(dev, cphd_res)
    hell_counts, hell_full_counts, hell_fused_counts = run_hellinger(dev)
    dense_counts = run_dense(dev)
    tile_rows = run_tiles(dev, errs)
    audit_dense_scale(dev)
    dense_seeds(dev)
    wide_counts, wide_rows = run_wide(dev, errs, slow_res)
    times = time_kernels(dev, errs, {**wide_rows, **tile_rows})
    profile_step(SynthSLAMRunner(load_config(CFG, {"n_particles": P_MAIN}),
                                 DATA, device=dev), "ackerman")
    profile_step(mixed_runner(dev), "mixed")
    profile_step(disparity_runner(dev), "disparity", host=(30, 40),
                 prof=(20, 30), prefix="disp.")
    profile_step(SynthSLAMRunner(load_config(CPHD_CFG,
                                             {"n_particles": P_MAIN}),
                                 DATA, device=dev), "cphd",
                 prefix=("phd.", "cphd."))
    profile_step(SynthSLAMRunner(load_config(DENSE_CFG,
                                             {"n_particles": P_DENSE}),
                                 DENSE_DATA, device=dev), "dense")
    profile_step(SynthSLAMRunner(load_config(CFG, dict(
        EAP, n_particles=P_MAIN)), DATA, device=dev), "ackerman EAP")
    profile_step(SynthSLAMRunner(load_config(DENSE_CFG, dict(
        EAP, n_particles=P_DENSE)), DENSE_DATA, device=dev), "dense EAP")
    # launches: each kernel's count in the run of the first path that runs
    # it (detect, gather_cols and merge2d: ackerman; detect_adaptive and
    # merge2d_tables: ackerman fused + adaptive; detect_cons: ackerman
    # consolidating; detect_cons_adaptive: dense consolidating + adaptive;
    # merge4d: mixed; merge3d: disparity; merge2d_argmax: the full-grid PHD
    # run; merge2d_hellinger, merge2d_argmax_hellinger and
    # merge2d_tables_hellinger: the Hellinger runs; merge4d_argmax: the
    # mixed per-particle run; merge4d_hellinger: the mixed
    # distance_metric=1 accuracy runs; merge3d_hellinger: data/disparity
    # with the Hellinger merge); every path's kernels
    # were required > 0 there, the CPHD and dense runs' too. gather_rows is
    # on no path (the JAX package's paths never call it), and no path's
    # slab exceeds the gathers' shared-memory budget (gather_cols_ldg,
    # gather_rows_ldg): 0.
    path_counts = [(ACKERMAN_KERNELS, counts), (KNOB_KERNELS, knob_counts),
                   (CONS_KERNELS, cons_counts),
                   (DENSE_KERNELS["consolidating + adaptive"],
                    dense_counts["consolidating + adaptive"]),
                   (MIXED_KERNELS, mixed_counts),
                   (DISP_KERNELS, disp_counts), (CPHD_KERNELS, cphd_counts),
                   (FULL_GRID_KERNELS, grid_counts),
                   (HELL_KERNELS, hell_counts),
                   (HELL_FULL_KERNELS, hell_full_counts),
                   (HELL_FUSED_KERNELS, hell_fused_counts),
                   (MIXED_SLOW_KERNELS, slow_counts),
                   (MIXED_HELL_KERNELS, mixed_hell_counts),
                   (DISP_HELL_KERNELS, disp_hell_counts), *wide_counts,
                   (tuple(KERNELS), {})]
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": int(next(c for ks, c in path_counts
                              if name in ks).get(name, 0)),
         "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": times[name][3], "bound_by": times[name][4],
         "library_ms": times[name][2], "device_ms": times[name][5],
         "library_device_ms": times[name][6]}
        for name, (src, rep) in KERNELS.items()]}
    phase("total", f"{time.perf_counter() - t_start:.1f} s")
    print(phases_line(seconds))
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
