"""SLAM runners (port of ``phdslam_tpu/slam.py``: ``build_schedule`` and
the step-by-step runner, plus the in-memory scan runner that the JAX
package builds inline in ``eval/parity.py::_mixed_scan_fn`` and
``tools/bench_mixed.py``).

The scans and the particle state live on the device for the whole run.
The host holds the schedule (which steps predict, which carry
measurements, the controls and dt), so it branches in Python without
reading the device; the noise comes from a ``torch.Generator`` on the
device seeded from ``cfg.seed``, and the MC variance estimator's samples
(compute_variance) from a second one seeded alike, so the estimator
leaves the trajectory's draws untouched. The only host reads in the loop are the
NaN checks, one per chunk of steps.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .config import SlamConfig
from .filters.cphd import cphd_constants
from .filters.phd import StepNoise, check_supported, phd_step
from .runtime import io
from .types import init_state


@dataclass
class StepPlan:
    """One entry of the input schedule."""
    z_idx: int          # measurement set index, -1 if none
    c_idx: int          # control index, -1 if none
    dt: float
    do_predict: bool


def build_schedule(n_measure_steps: int, n_controls: int,
                   measurement_times: np.ndarray, control_times: np.ndarray,
                   dt_default: float, n_steps_limit: int) -> List[StepPlan]:
    """Interleave measurement/control inputs by timestamp.

    Without timestamps: one measurement set + previous control per step.
    """
    plans: List[StepPlan] = []
    if len(measurement_times) == 0:
        for n in range(n_measure_steps):
            plans.append(StepPlan(z_idx=n, c_idx=min(n - 1, n_controls - 1)
                                  if n > 0 else -1,
                                  dt=dt_default, do_predict=n > 0))
    else:
        z_idx = c_idx = 0
        current_time = 0.0
        while z_idx < len(measurement_times) and c_idx < len(control_times):
            if measurement_times[z_idx] < control_times[c_idx]:
                t = float(control_times[c_idx])  # sic: the control time
                plans.append(StepPlan(z_idx=z_idx, c_idx=-1,
                                      dt=t - current_time, do_predict=True))
                current_time = t
                z_idx += 1
            elif measurement_times[z_idx] == control_times[c_idx]:
                t = float(control_times[c_idx])
                plans.append(StepPlan(z_idx=z_idx, c_idx=c_idx,
                                      dt=t - current_time, do_predict=True))
                current_time = t
                z_idx += 1
                c_idx += 1
            else:
                t = float(control_times[c_idx])
                plans.append(StepPlan(z_idx=-1, c_idx=c_idx,
                                      dt=t - current_time, do_predict=True))
                current_time = t
                c_idx += 1
    if n_steps_limit > 0:
        plans = plans[:n_steps_limit]
    return plans


class _Runner:
    """The step loop shared by the runners: a subclass sets ``state`` and
    ``n_steps`` and provides :meth:`step_args`."""

    def __init__(self, cfg: SlamConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.var_generator = None
        if cfg.compute_variance:
            self.var_generator = torch.Generator(device=self.device)
            self.var_generator.manual_seed(cfg.seed)
        # the CPHD update's constant tables, built once per run
        self.consts = (cphd_constants(cfg, device=self.device)
                       if cfg.filter_type == 1 else None)

    def step_args(self, n: int):
        """Host-side inputs of step n, as phd_step takes them:
        (z, z_mask, control, dt, do_predict, has_z)."""
        raise NotImplementedError

    def noise(self) -> StepNoise:
        """The next step's draws from the runner's generator: one
        prediction draw per sub-step for each of the P k predicted
        particles (k = n_predict_particles), 3 accelerations for the CV
        vehicle (motion_type 0), 2 control perturbations for Ackerman, and
        P resampling uniforms; with compute_variance, a source of the
        estimator's samples, drawn from the second generator when the
        estimator asks for them."""
        P = self.state.pose.shape[0]
        k = max(1, self.cfg.n_predict_particles)
        sub = max(1, self.cfg.subdivide_predict)
        width = 3 if self.cfg.motion_type == 0 else 2
        var_draw = None
        if self.var_generator is not None:
            def var_draw(s, shape, g=self.var_generator):
                return torch.randn(shape, generator=g, device=self.device)
        return StepNoise(
            eps_pred=torch.randn((sub, P * k, width),
                                 generator=self.generator,
                                 device=self.device),
            u_resample=torch.rand((P,), generator=self.generator,
                                  device=self.device),
            var_draw=var_draw)

    def step(self, n: int):
        """Run step n on the runner's state; returns the step's outputs."""
        z, zm, control, dt, do_predict, has_z = self.step_args(n)
        self.state, out = phd_step(self.state, z, zm, control, dt,
                                   do_predict, self.cfg, self.noise(),
                                   has_z=has_z, consts=self.consts)
        return out

    def _after_step(self, n: int, out) -> None:
        """Called after step n (and after its timing, with ``timing``)."""

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, check_every: int = 32, timing: bool = False,
            collect_maps: bool = False):
        """Run every step. Raises FloatingPointError at the first chunk of
        ``check_every`` steps whose weights or poses hold a NaN.

        Returns est_poses [T, D] (the step's expected pose), n_eff [T],
        resampled [T], the largest overflow count, wall_s and steps_per_s
        (host clock around the whole loop, ending in a device synchronize),
        and step_ms: with ``timing``, each step's own time (host clock,
        synchronized after every step), else None. With ``collect_maps``,
        also each step's MAP map (map_means [T, K, 2], map_weights [T, K]),
        kept on the device until the end.
        """
        poses, n_effs, resampled, overflows, step_ms = [], [], [], [], []
        maps = []
        self._sync()
        t0 = time.perf_counter()
        T = self.n_steps
        for n in range(T):
            t_step = time.perf_counter()
            out = self.step(n)
            if timing:
                self._sync()
                step_ms.append((time.perf_counter() - t_step) * 1000.0)
            self._after_step(n, out)
            if collect_maps:
                # copies: the MAP map is a view into the whole [P, K] map,
                # which the list would otherwise keep alive every step
                maps.append((out.map_mean.clone(), out.map_weight.clone()))
            poses.append(out.expected_pose)
            n_effs.append(out.n_eff)
            resampled.append(out.resampled)
            overflows.append(out.overflow)
            if (n + 1) % check_every == 0 or n + 1 == T:
                lo = n - n % check_every
                bad = torch.isnan(torch.stack(n_effs[lo:])).any() \
                    | torch.isnan(torch.stack(poses[lo:])).any()
                if bool(bad):
                    raise FloatingPointError(
                        f"nan weights or poses in steps {lo}..{n}")
        self._sync()
        wall = time.perf_counter() - t0
        res = {
            "est_poses": torch.stack(poses).cpu().numpy(),
            "n_eff": torch.stack(n_effs).cpu().numpy(),
            "resampled": torch.stack(resampled).cpu().numpy(),
            "overflow": int(torch.stack(overflows).max()),
            "wall_s": wall,
            "steps_per_s": T / wall,
            "step_ms": np.asarray(step_ms) if timing else None,
        }
        if collect_maps:
            for i, key in enumerate(("map_means", "map_weights")):
                res[key] = torch.stack([m[i] for m in maps]).cpu().numpy()
        return res


class SynthSLAMRunner(_Runner):
    """End-to-end filter runner on a dataset directory."""

    def __init__(self, cfg: SlamConfig, data_dir: Optional[str] = None,
                 device="cuda"):
        super().__init__(cfg, device)
        data_dir = data_dir or cfg.data_directory
        measurements = io.load_measurements(
            os.path.join(data_dir, "measurements.txt"),
            labeled=cfg.labeled_measurements)
        controls_path = os.path.join(data_dir, "controls.txt")
        self.controls = (io.load_controls(controls_path)
                         if os.path.exists(controls_path)
                         else np.zeros((0, 2), np.float32))
        mt = io.load_timestamps(os.path.join(data_dir,
                                             "measurement_times.txt"))
        ct = io.load_timestamps(os.path.join(data_dir, "control_times.txt"))

        # pad scans to the longest one, rounded up to 8, within the config cap
        longest = max((len(z) for z in measurements), default=1)
        m_max = min(max(8, int(np.ceil(longest / 8.0)) * 8),
                    cfg.max_measurements)
        self.m_max = m_max
        self.z, self.z_mask = io.pad_measurements(measurements, m_max)
        self.n_truncated = sum(max(0, len(z) - m_max) for z in measurements)
        self.schedule = build_schedule(
            len(measurements), len(self.controls), mt, ct, cfg.dt,
            cfg.n_steps)
        self.n_steps = len(self.schedule)
        check_supported(cfg, cfg.max_components, m_max)

        self.state = init_state(cfg, device=self.device)
        self.z_dev = torch.as_tensor(self.z, device=self.device)
        self.mask_dev = torch.as_tensor(self.z_mask, device=self.device)
        self._zeros_z = torch.zeros((m_max, 2), dtype=torch.float32,
                                    device=self.device)
        self._zeros_mask = torch.zeros((m_max,), dtype=torch.bool,
                                       device=self.device)
        # the control each step applies: a step without one reuses the last
        self.step_controls = []
        control = (0.0, 0.0)
        for plan in self.schedule:
            if plan.c_idx >= 0:
                control = tuple(float(v) for v in self.controls[plan.c_idx])
            self.step_controls.append(control)

    def step_args(self, n: int):
        plan = self.schedule[n]
        if plan.z_idx >= 0:
            z, zm = self.z_dev[plan.z_idx], self.mask_dev[plan.z_idx]
            has_z = bool(self.z_mask[plan.z_idx].any())
        else:
            z, zm, has_z = self._zeros_z, self._zeros_mask, False
        return (z, zm, self.step_controls[n], plan.dt, plan.do_predict,
                has_z)

    def run(self, check_every: int = 32, timing: bool = False,
            collect_maps: bool = False):
        res = super().run(check_every, timing, collect_maps)
        res["truncated_measurements"] = self.n_truncated
        res["m_max"] = self.m_max
        return res


class ScanRunner(_Runner):
    """Filter runner over scans held in memory: z_all [T, M, 2] and
    mask_all [T, M] (numpy), one scan per step, every step after the first
    predicting over ``dt`` with a zero control. This is how the JAX package
    runs its synthetic mixed worlds and its mixed benchmark
    (``eval/parity.py::_mixed_scan_fn``, ``tools/bench_mixed.py``)."""

    def __init__(self, cfg: SlamConfig, z_all, mask_all, dt: float,
                 device="cuda"):
        super().__init__(cfg, device)
        z_all = np.asarray(z_all, np.float32)
        mask_all = np.asarray(mask_all, bool)
        self.n_steps, m_max = mask_all.shape
        self.dt = float(dt)
        self.has_z = mask_all.any(axis=1)
        check_supported(cfg, cfg.max_components, m_max)
        self.state = init_state(cfg, device=self.device)
        self.z_dev = torch.as_tensor(z_all, device=self.device)
        self.mask_dev = torch.as_tensor(mask_all, device=self.device)

    def step_args(self, n: int):
        return (self.z_dev[n], self.mask_dev[n], (0.0, 0.0), self.dt, n > 0,
                bool(self.has_z[n]))
