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
leaves the trajectory's draws untouched. A checkpoint carries both
generators' states, so a resumed run draws what the uninterrupted one
does. The loop reads nothing from the card unless asked to check every
step for NaN (``debug``); it writes the reference's state logs after the
run.

On a particle mesh (``mesh``, ``parallel/sharding.py``; :meth:`_Runner.
run_sharded`) every rank runs the same loop on its block: it draws the
step's global noise from its generator (the same on every rank) and
keeps its rows, and the per-particle outputs are gathered after the run.
Only the primary rank writes logs, ``loopTime.log`` and checkpoints (the
gathered global state); any number of ranks can resume a checkpoint.
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
from .filters.phd import (StepNoise, check_supported, expand_particles,
                          phd_step, predict)
from .parallel.sharding import (gather_state, local_noise, make_mesh,
                                shard_state)
from .runtime import io, profiling
from .runtime.checkpoint import load_checkpoint, save_checkpoint
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


# step outputs that may be views into the whole particle state
_VIEWS = ("map_mean", "map_weight", "log_weight", "poses", "resample_idx",
          "map_cov", "cardinality")


# per-particle step outputs: this rank's rows on a mesh
PER_PARTICLE_OUTPUTS = ("log_weight", "poses", "resample_idx")


class _Runner:
    """The step loop shared by the runners: a subclass sets ``state`` and
    ``n_steps`` and provides :meth:`step_args`; given a particle ``mesh``,
    it calls :meth:`attach_mesh` once the global initial state is set."""

    def __init__(self, cfg: SlamConfig, device, mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the runner's device {self.device} is not "
                             f"the mesh's {mesh.device}")
        self.mesh = None
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

    def attach_mesh(self, mesh) -> None:
        """Keep this rank's block of the (global) state and run every
        later step on ``mesh``."""
        if mesh is None or mesh is self.mesh:
            return
        if self.mesh is not None:
            raise ValueError("the runner already runs on another mesh")
        self.state = shard_state(mesh, self.state)
        self.mesh = mesh

    @property
    def primary(self) -> bool:
        """Whether this process writes the logs and checkpoints."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def n_particles(self) -> int:
        """The particle count over every rank."""
        return self.state.log_weight.shape[0] * (
            1 if self.mesh is None else self.mesh.size)

    def global_state(self):
        """The whole state (gathered from every rank on a mesh)."""
        return (self.state if self.mesh is None
                else gather_state(self.mesh, self.state))

    def local_noise(self, noise):
        """This rank's rows of a step's global draws."""
        return local_noise(noise, self.mesh)

    def noise(self) -> StepNoise:
        """The next step's draws from the runner's generator: one
        prediction draw per sub-step for each of the P k predicted
        particles (k = n_predict_particles), 3 accelerations for the CV
        vehicle (motion_type 0), 2 control perturbations for Ackerman, and
        P resampling uniforms; with compute_variance, a source of the
        estimator's samples, drawn from the second generator when the
        estimator asks for them. On a mesh these are the global draws
        (every rank draws the same)."""
        P = self.n_particles
        k = max(1, self.cfg.n_predict_particles)
        sub = max(1, self.cfg.subdivide_predict)
        width = 3 if self.cfg.motion_type == 0 else 2
        var_draw = None
        if self.var_generator is not None:
            def var_draw(s, shape, g=self.var_generator):
                return torch.randn(shape, generator=g, device=self.device)
        with profiling.span("runner.noise"):
            return StepNoise(
                eps_pred=torch.randn((sub, P * k, width),
                                     generator=self.generator,
                                     device=self.device),
                u_resample=torch.rand((P,), generator=self.generator,
                                      device=self.device),
                var_draw=var_draw)

    def step(self, n: int, noise=None):
        """Run step n on the runner's state (on ``noise``, this rank's rows
        of the draws, else the next draws of the generator); returns the
        step's outputs."""
        if noise is None:
            noise = self.local_noise(self.noise())
        self.state, out = self.step_state(self.state, n, noise, self.mesh)
        return out

    def step_state(self, state, n: int, noise, mesh=None,
                   return_updated: bool = False):
        """Step n of the schedule from ``state`` (this rank's block on a
        ``mesh``) on ``noise``, leaving the runner's state untouched: the
        filter step's (state, outputs[, log weights before resampling])."""
        with profiling.span("runner.step"):
            z, zm, control, dt, do_predict, has_z = self.step_args(n)
            return phd_step(state, z, zm, control, dt, do_predict, self.cfg,
                            noise, has_z=has_z, consts=self.consts,
                            mesh=mesh, return_updated=return_updated)

    def predict_only(self, n: int, noise):
        """Step n's prediction alone, on the step's own draws and the
        runner's state (shotgunned first, as the step does), leaving both
        untouched: what ``run(timing=True)`` times for predicttime.log.
        None when step n does not predict."""
        _, _, control, dt, do_predict, _ = self.step_args(n)
        if not do_predict:
            return None
        state = self.state
        k = max(1, self.cfg.n_predict_particles)
        if k > 1:
            state = expand_particles(state, k)
        return predict(state, control, dt, self.cfg, noise.eps_pred)

    def _after_step(self, n: int, out) -> None:
        """Called after step n (and after its timing, with ``timing``)."""

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wait(self) -> None:
        """The loop's wait for the card (span ``runner.wait``)."""
        with profiling.span("runner.wait"):
            self._sync()

    def save(self, path: str, steps_done: int) -> None:
        """Checkpoint the state after ``steps_done`` steps, with the
        generators' states (the draws of every later step depend on them)
        and the control carried into the next step. On a mesh every rank
        gathers the state and the primary writes it."""
        state = self.global_state()
        if not self.primary:
            return
        last = self.last_control(steps_done)
        extra = {"step": steps_done,
                 "last_ctrl": torch.tensor(last, dtype=torch.float32),
                 "generator": self.generator.get_state(),
                 "generator_device": self.device.type}
        if self.var_generator is not None:
            extra["var_generator"] = self.var_generator.get_state()
        save_checkpoint(path, state, extra)

    def restore(self, path: str) -> int:
        """Load a checkpoint written by :meth:`save` into this runner (state
        and generators; on a mesh of any size, this rank's block of the
        saved global state); returns the step to resume at."""
        state, extra = load_checkpoint(path, self.global_state(),
                                       extra_like={})
        kind = (extra or {}).get("generator_device")
        if kind != self.device.type:
            raise ValueError(
                f"checkpoint {path} holds a {kind} generator state, and "
                f"this runner draws on {self.device.type}: resume on the "
                "device type that saved it (a generator cannot be carried "
                "across, and reseeding would change every later draw)")
        self.generator.set_state(extra["generator"].cpu())
        if self.var_generator is not None:
            if "var_generator" not in extra:
                raise ValueError(
                    f"checkpoint {path} holds no variance generator state: "
                    "it was saved without compute_variance")
            self.var_generator.set_state(extra["var_generator"].cpu())
        self.state = (state if self.mesh is None
                      else shard_state(self.mesh, state))
        return int(extra["step"])

    def last_control(self, n: int):
        """The control carried into step n (after step n - 1)."""
        return (0.0, 0.0)

    def run(self, out_dir: Optional[str] = None, log_every: int = 1,
            chunk: int = 64, timing: bool = False,
            collect_maps: bool = False, collect_particles: bool = False,
            checkpoint_every: int = 0, checkpoint_dir: Optional[str] = None,
            start_step: int = 0, debug: Optional[bool] = None):
        """Run steps ``start_step`` .. T - 1 in chunks of ``chunk`` steps
        (0: the whole run as one chunk).

        The loop reads nothing from the card. It waits for the card at the
        end of each chunk, to record the chunk's wall time (chunk_ms), and,
        with ``timing``, after every step (step_ms, each step's own time
        from its issue to its outputs on the card, and predict_ms, the
        prediction alone run beforehand on the step's own draws and timed
        apart; 0 on steps that do not predict). With
        ``checkpoint_every`` and ``checkpoint_dir``, a chunk boundary
        that reaches the next multiple of ``checkpoint_every`` steps saves
        ``checkpoint_dir/stepNNNNN`` (:meth:`save`); ``start_step`` resumes
        after :meth:`restore` and must be a chunk boundary.

        NaN weights: after the loop the first step whose nEff is NaN is
        printed as ``nan weights detected at step N!`` and returned as
        nan_step (None when every step is clean); the results come back
        all the same. With ``debug`` (default: inside
        ``runtime.profiling.debug_mode``) every step is checked and the
        first NaN raises FloatingPointError.

        Returns est_poses [T, D] (the step's expected pose), n_eff [T],
        resampled [T], the largest overflow count, wall_s and steps_per_s
        (host clock around the loop, ending in a device synchronize),
        ``n_devices`` (the mesh's ranks, 1 without one),
        chunk, chunk_ms, step_ms and predict_ms (None without ``timing``),
        start_step and nan_step; steps before ``start_step`` are zeros.
        With ``collect_maps``, each step's MAP map (map_means [T, K, 2],
        map_weights [T, K]); with ``collect_particles``, log_weights
        [T, P], poses [T, P, 6], resample_idx [T, P], map_covs
        [T, K, 2, 2] and cardinalities [T, C + 1] (CPHD; [T, 1] zeros
        otherwise), all kept on the card until the end (on a mesh each
        rank keeps its rows and they are gathered after the loop).
        ``out_dir`` collects both and writes the logs (:meth:`write_logs`;
        the primary rank alone on a mesh).
        """
        T = self.n_steps
        chunk = chunk if chunk > 0 else T
        if start_step % chunk:
            raise ValueError(
                f"start_step ({start_step}) must be a multiple of the chunk "
                f"size ({chunk}) — checkpoints are saved at chunk boundaries")
        if start_step >= T:
            raise ValueError(
                f"start_step ({start_step}) is at or past the end of the "
                f"{T}-step schedule — nothing to resume")
        if debug is None:
            debug = profiling.nan_checks()
        if out_dir:
            collect_maps = collect_particles = True
        next_ckpt = None
        if checkpoint_every > 0 and checkpoint_dir:
            next_ckpt = (start_step // checkpoint_every + 1) * checkpoint_every
        keys = ["expected_pose", "n_eff", "resampled", "overflow"]
        if collect_maps:
            keys += ["map_mean", "map_weight"]
        if collect_particles:
            keys += ["log_weight", "poses", "resample_idx", "map_cov",
                     "cardinality"]
        ys = {k: [] for k in keys}
        step_ms, predict_ms, chunk_ms = [], [], []
        self._sync()
        t0 = t_chunk = time.perf_counter()
        for n in range(start_step, T):
            noise = self.local_noise(self.noise())
            if timing:
                pred, p_ms = profiling.timed_call(self.predict_only, n, noise)
                predict_ms.append(p_ms if pred is not None else 0.0)
                t_step = time.perf_counter()
            out = self.step(n, noise)
            if timing:
                self._wait()
                step_ms.append((time.perf_counter() - t_step) * 1000.0)
            if debug and bool(torch.isnan(out.n_eff)
                              | torch.isnan(out.expected_pose).any()):
                raise FloatingPointError(f"nan weights detected at step {n}")
            self._after_step(n, out)
            for k in keys:
                v = getattr(out, k)
                # copies of the maps and particles: each may be a view into
                # the whole state, which the list would otherwise keep alive
                ys[k].append(v.clone() if k in _VIEWS and v is not None
                             else v)
            if (n + 1) % chunk == 0 or n + 1 == T:
                self._wait()
                now = time.perf_counter()
                chunk_ms.append((now - t_chunk) * 1000.0)
                t_chunk = now
                if next_ckpt is not None and n + 1 >= next_ckpt:
                    self.save(os.path.join(checkpoint_dir,
                                           f"step{n + 1:05d}"), n + 1)
                    next_ckpt = ((n + 1) // checkpoint_every + 1) \
                        * checkpoint_every
        wall = time.perf_counter() - t0

        def stacked(k):
            if ys[k][0] is None:        # the PHD filter's cardinality
                x = np.zeros((T - start_step, 1), np.float32)
            else:
                x = torch.stack(ys[k])
                if self.mesh is not None and k in PER_PARTICLE_OUTPUTS:
                    x = self.mesh.all_gather(
                        x.transpose(0, 1).contiguous()).transpose(0, 1)
                x = x.cpu().numpy()
            if start_step:              # zero-fill the resumed-over steps
                x = np.concatenate([np.zeros((start_step,) + x.shape[1:],
                                             x.dtype), x])
            return x
        n_eff = stacked("n_eff")
        bad = np.flatnonzero(np.isnan(n_eff[start_step:]))
        nan_step = int(bad[0]) + start_step if bad.size else None
        if nan_step is not None:
            print(f"nan weights detected at step {nan_step}!")
        res = {
            "est_poses": stacked("expected_pose"),
            "n_eff": n_eff,
            "resampled": stacked("resampled"),
            "overflow": int(torch.stack(ys["overflow"]).max()),
            "wall_s": wall,
            "steps_per_s": (T - start_step) / wall,
            "chunk": chunk,
            "chunk_ms": np.asarray(chunk_ms),
            "step_ms": np.asarray(step_ms) if timing else None,
            "predict_ms": np.asarray(predict_ms) if timing else None,
            "start_step": start_step,
            "nan_step": nan_step,
            "n_devices": 1 if self.mesh is None else self.mesh.size,
        }
        if collect_maps:
            res["map_means"] = stacked("map_mean")
            res["map_weights"] = stacked("map_weight")
        if collect_particles:
            for key, k in (("log_weights", "log_weight"), ("poses", "poses"),
                           ("resample_idx", "resample_idx"),
                           ("map_covs", "map_cov"),
                           ("cardinalities", "cardinality")):
                res[key] = stacked(k)
        if out_dir and self.primary:
            self.write_logs(out_dir, res, log_every)
        return res

    def run_sharded(self, mesh=None, **kwargs):
        """:meth:`run` on this rank's block of a particle ``mesh`` (by
        default every process of the group, :func:`parallel.sharding.
        make_mesh`, on the runner's device; without a group, the plain
        :meth:`run`): the JAX version's ``run_sharded``, here the same
        step loop. Returns run's result; its ``n_devices`` is the mesh's
        size."""
        self.attach_mesh(mesh or self.mesh
                         or make_mesh(device=self.device))
        return self.run(**kwargs)

    def write_logs(self, out_dir: str, res: dict, log_every: int = 1):
        """Write the state logs of a :meth:`run` result collected with
        ``collect_maps`` and ``collect_particles`` (one
        ``state_estimateXXXXX.log`` every ``log_every`` steps from
        start_step), ``loopTime.log`` (each step's time with ``timing``,
        else its chunk's time divided over the chunk's steps; zeros before
        start_step) and, with ``timing``, ``predicttime.log``."""
        cfg = self.cfg
        os.makedirs(out_dir, exist_ok=True)
        T = len(res["est_poses"])
        start = res["start_step"]
        cns = res["cardinalities"]
        for n in range(start, T, log_every):
            gm = (res["map_weights"][n], res["map_means"][n],
                  res["map_covs"][n])
            io.write_state_log(
                out_dir, n, res["est_poses"][n],
                gm if cfg.feature_model == 0 else None,
                gm if cfg.feature_model == 1 else None,
                res["log_weights"][n], res["poses"][n],
                res["resample_idx"][n], cns[n], cfg.max_cardinality,
                cfg.filter_type)
        step_ms = res["step_ms"]
        if step_ms is None:
            step_ms = chunk_step_ms(res["chunk_ms"], res["chunk"], start, T)
        else:
            step_ms = np.concatenate([np.zeros(start), step_ms])
        write_times(os.path.join(out_dir, "loopTime.log"), step_ms)
        if res["predict_ms"] is not None:
            write_times(os.path.join(out_dir, "predicttime.log"),
                        np.concatenate([np.zeros(start), res["predict_ms"]]))


def chunk_step_ms(chunk_ms, chunk: int, start: int, T: int) -> np.ndarray:
    """Per-step times from per-chunk ones: each chunk's time divided over
    its steps (the last chunk may be short), zeros before ``start``."""
    sizes = [min(chunk, T - lo) for lo in range(start, T, chunk)]
    return np.concatenate([np.zeros(start)] + [
        np.full((n,), ms / n) for ms, n in zip(chunk_ms, sizes)])


def write_times(path: str, times_ms) -> None:
    """One ``%g`` time in ms per line (loopTime.log, predicttime.log)."""
    with open(path, "w") as fh:
        fh.write("\n".join("%g" % t for t in times_ms) + "\n")


class SynthSLAMRunner(_Runner):
    """End-to-end filter runner on a dataset directory."""

    def __init__(self, cfg: SlamConfig, data_dir: Optional[str] = None,
                 device="cuda", mesh=None):
        super().__init__(cfg, device, mesh)
        self.data_dir = data_dir = data_dir or cfg.data_directory
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
        self.attach_mesh(mesh)

    def step_args(self, n: int):
        plan = self.schedule[n]
        if plan.z_idx >= 0:
            z, zm = self.z_dev[plan.z_idx], self.mask_dev[plan.z_idx]
            has_z = bool(self.z_mask[plan.z_idx].any())
        else:
            z, zm, has_z = self._zeros_z, self._zeros_mask, False
        return (z, zm, self.step_controls[n], plan.dt, plan.do_predict,
                has_z)

    def last_control(self, n: int):
        return self.step_controls[n - 1] if n > 0 else (0.0, 0.0)

    def run(self, *args, **kwargs):
        res = super().run(*args, **kwargs)
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
                 device="cuda", mesh=None):
        super().__init__(cfg, device, mesh)
        z_all = np.asarray(z_all, np.float32)
        mask_all = np.asarray(mask_all, bool)
        self.n_steps, m_max = mask_all.shape
        self.dt = float(dt)
        self.has_z = mask_all.any(axis=1)
        check_supported(cfg, cfg.max_components, m_max)
        self.state = init_state(cfg, device=self.device)
        self.z_dev = torch.as_tensor(z_all, device=self.device)
        self.mask_dev = torch.as_tensor(mask_all, device=self.device)
        self.attach_mesh(mesh)

    def step_args(self, n: int):
        return (self.z_dev[n], self.mask_dev[n], (0.0, 0.0), self.dt, n > 0,
                bool(self.has_z[n]))
