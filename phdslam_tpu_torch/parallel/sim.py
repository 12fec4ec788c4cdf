"""Multi-process runs of the sharded filter on one machine (the port's
``tools/multihost_sim.py``).

    python -m phdslam_tpu_torch.parallel.sim --nproc N --steps S
        [--disparity] [--ckpt-test] [--device cuda|cpu]
        [--backend gloo|nccl] [--particles P]

spawns N processes wired into one ``torch.distributed`` group over a
``file://`` store in a temporary directory, with a wall limit on the whole
group (a rank that fails or hangs ends the group). Each rank holds P / N
particles of the JAX harness's small scene (resampling forced on every
step, so the migration runs) and steps them with the sharded step; on
every step every rank also runs the 1-process step on the gathered state
with the same global draws, and the two are held to the step gates
(:class:`Gate`; where a resampling stratum on a cumulative-weight
boundary takes another ancestor, the run resyncs to the 1-process state).
Prints ``PARITY`` or ``MISMATCH`` and one JSON line, and exits non-zero on
a mismatch. ``--ckpt-test`` saves a checkpoint from 2 ranks halfway,
resumes it on N and holds the result to the uninterrupted 1-process run.
The ranks run on the card unless ``--device cpu`` asks for the CPU
(Gloo): ``--backend nccl`` (the default on the card) takes one GPU per
rank, ``--backend gloo`` shares the one GPU among the ranks (staged
through host memory).

The same machinery is a Python API (:func:`run_group` with a task dict)
that the tests and ``chip_smoke.py`` drive: "gated" (the above on any
runner), "run" (a free-running sharded run, with a checkpoint saved or
resumed), "replay" (recorded inputs and draws through the sharded step,
for comparison with the JAX package) and "cli" (the command line on every
rank).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional
from unittest import mock

import numpy as np

DEFAULT_TIMEOUT_S = 120.0
INIT_TIMEOUT_S = 60.0           # a rank's wait for its peers, at init and
                                # in each collective
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ----------------------------------------------------------------------------
# the parent: spawn, watch, collect
# ----------------------------------------------------------------------------

def run_group(nproc: int, task: dict, device="cuda",
              backend: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``task`` on a group of ``nproc`` ranks on ``device`` (the
    backend the device's, :func:`.distributed.backend_for`, unless given)
    and return each rank's result dict, rank 0's arrays under "arrays".
    The group shares one ``file://`` store in a new temporary directory;
    it is killed when any rank fails or when ``timeout_s`` passes, and a
    RuntimeError carries the failed rank's output."""
    from .distributed import backend_for
    backend = backend_for(device, backend)
    with tempfile.TemporaryDirectory(prefix="sim_") as tmp:
        spec = {"nproc": nproc, "device": device, "backend": backend,
                "store": "file://" + os.path.join(tmp, "store"),
                "out": tmp, "task": task}
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as fh:
            json.dump(spec, fh)
        if device == "cuda":
            from ..kernels import build
            build.build()       # once, before the ranks load it
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   LOCAL_WORLD_SIZE=str(nproc))
        procs, logs = [], []
        try:
            for r in range(nproc):
                logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "phdslam_tpu_torch.parallel.sim",
                     "--child", str(r), spec_path],
                    stdout=logs[-1], stderr=subprocess.STDOUT, cwd=os.getcwd(),
                    env=dict(env, LOCAL_RANK=str(r))))
            _wait(procs, logs, timeout_s)
            out = []
            for r in range(nproc):
                with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                    out.append(json.load(fh))
            arrays = os.path.join(tmp, "rank0.npz")
            if os.path.exists(arrays):
                with np.load(arrays) as z:
                    out[0]["arrays"] = {k: z[k] for k in z.files}
            return out
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for lg in logs:
                lg.close()


def _wait(procs, logs, timeout_s):
    deadline = time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        late = time.monotonic() > deadline
        if failed or late:
            r = failed[0] if failed else 0
            logs[r].seek(0)
            tail = logs[r].read()[-4000:]
            what = (f"rank {r} exited with {codes[r]}" if failed
                    else f"the group passed its {timeout_s:.0f} s limit")
            raise RuntimeError(f"{what}:\n{tail}")
        if all(c == 0 for c in codes):
            return
        time.sleep(0.1)


# ----------------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------------

def _child(rank: int, spec_path: str) -> None:
    with open(spec_path) as fh:
        spec = json.load(fh)
    import torch

    from . import distributed
    from .sharding import make_mesh
    n = spec["nproc"]
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * n)))
    device = spec["device"]
    distributed.initialize(spec["store"], n, rank, spec["backend"], device,
                           INIT_TIMEOUT_S)
    mesh = make_mesh(device=distributed.local_device(device))
    res, arrays = run_task_kind(spec["task"], mesh, device)
    res.update(rank=rank, transport=mesh.transport, device=str(mesh.device))
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    if rank == 0 and arrays:
        np.savez(os.path.join(spec["out"], "rank0.npz"), **arrays)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def run_task_kind(task, mesh, device):
    """(result dict, arrays or None) of one task on this rank: "each" runs
    its ``tasks`` in turn (results under "results", arrays prefixed
    "t<i>_")."""
    if task["kind"] == "cli":
        from ..__main__ import main
        return {"rc": main(task["argv"], device=device)}, None
    if task["kind"] != "each":
        res, arrays = TASKS[task["kind"]](task, mesh)
        return dict(res, transport=mesh.transport), arrays
    results, arrays = [], {}
    for i, sub in enumerate(task["tasks"]):
        res, arr = run_task_kind(sub, mesh, device)
        results.append(res)
        arrays.update({f"t{i}_{k}": v for k, v in (arr or {}).items()})
    return {"results": results}, arrays


def build_cfg(spec: dict):
    """A config from a task: ``cfg`` (a file) with ``overrides``, or
    ``fields`` (SlamConfig's own)."""
    from ..config import SlamConfig, load_config
    if "cfg" in spec:
        return load_config(spec["cfg"], spec.get("overrides"))
    return SlamConfig(**spec["fields"])


def build_runner(spec: dict, cfg, mesh, device=None):
    """The runner a task names, on ``mesh`` (None: the whole state on
    ``device``): "synth" (a dataset directory, ``data``), "scan" (scans
    held in memory: ``npz`` with z_all and mask_all, or ``fixed``
    measurements repeated over ``steps``; ``dt``) or "disparity" (an
    image-measurement directory)."""
    from ..slam import ScanRunner, SynthSLAMRunner
    from ..slam_disparity import DisparityRunner
    kind, dev = spec["runner"], (mesh.device if mesh else device)
    if kind == "synth":
        return SynthSLAMRunner(cfg, spec.get("data"), device=dev, mesh=mesh)
    if kind == "disparity":
        return DisparityRunner(cfg, spec.get("data"), device=dev, mesh=mesh)
    if "npz" in spec:
        with np.load(spec["npz"]) as z:
            z_all, mask_all = z["z_all"], z["mask_all"]
    else:
        fixed = np.asarray(spec["fixed"], np.float32)
        z_all = np.zeros((spec["steps"], cfg.max_measurements, 2),
                         np.float32)
        z_all[:, :len(fixed)] = fixed
        mask_all = np.zeros(z_all.shape[:2], bool)
        mask_all[:, :len(fixed)] = True
    return ScanRunner(cfg, z_all, mask_all, spec.get("dt", cfg.dt),
                      device=dev, mesh=mesh)


def _counts():
    from ..kernels import build
    return dict(build.launch_counts)


def _launched_by(fn, *args):
    """fn(*args) and the kernel launches it made."""
    from ..kernels import build
    before = dict(build.launch_counts)
    out = fn(*args)
    return out, {k: v - before.get(k, 0)
                 for k, v in build.launch_counts.items()
                 if v != before.get(k, 0)}


def _reset_counts():
    from ..kernels import build
    build.reset_launch_counts()


def _replayable(noise):
    """The step's draws with the variance samples kept, so the sharded and
    the 1-process step read the same ones."""
    if getattr(noise, "var_draw", None) is None:
        return noise
    kept, draw = {}, noise.var_draw

    def again(s, shape):
        key = (s, tuple(shape))
        if key not in kept:
            kept[key] = draw(s, shape)
        return kept[key]
    return noise._replace(var_draw=again)


class Gate:
    """The step gates of a sharded step against the 1-process step from the
    same state and draws: every per-particle leaf and the step's outputs
    (expected pose, nEff, the MAP or EAP map, the MAP cardinality) within
    rtol / atol (rtol 1e-4 / atol 1e-5 by default, as the card-vs-CPU
    step checks), a map slot allowed to hold another component of its
    particle where the two weights tie within the tolerance (the
    compaction sorts by weight), the CPHD log cardinality compared within
    60 nats of each row's peak, the resampling decision and the overflow
    equal, and a stratum allowed another ancestor only where its point
    (j + u_j) / P lies within 1e-4 of a cumulative weight of the updated
    1-process state. ``bits``: the step's leaves and outputs all equal."""

    def __init__(self, rtol=1e-4, atol=1e-5):
        self.rtol, self.atol = rtol, atol
        self.max_err = 0.0

    def close(self, name, got, want):
        import torch
        rtol = self.rtol
        got, want = got.double().cpu(), want.double().cpu()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        if not torch.allclose(got, want, rtol=rtol, atol=self.atol,
                              equal_nan=False):
            bad = ~torch.isclose(got, want, rtol=rtol, atol=self.atol)
            raise AssertionError(
                f"{name}: {int(bad.sum())} of {bad.numel()} entries beyond "
                f"rtol {rtol} / atol {self.atol}, max |diff| "
                f"{float((got - want).abs().max()):.3g}")
        if got.numel():
            self.max_err = max(self.max_err,
                               float((got - want).abs().max()))

    def slots(self, name, g_w, g_x, c_w, c_x):
        """Per-particle slot payloads ``g_x`` [P, K, ...] against ``c_x``,
        a weight-tied slot free to hold another equal component."""
        import torch
        g_w, c_w = g_w.double().cpu(), c_w.double().cpu()
        g_x = g_x.double().cpu().flatten(2)
        c_x = c_x.double().cpu().flatten(2)
        ok = torch.isclose(g_x, c_x, rtol=self.rtol, atol=self.atol).all(-1)
        for p, k in (~ok).nonzero().tolist():
            tied = torch.isclose(c_w[p], g_w[p, k], rtol=self.rtol,
                                 atol=self.atol)
            same = torch.isclose(c_x[p], g_x[p, k], rtol=self.rtol,
                                 atol=self.atol).all(-1)
            if not bool((tied & same).any()):
                raise AssertionError(f"{name}: particle {p} slot {k} matches "
                                     "no weight-tied component")
        return int((~ok).sum())

    def strata(self, g_idx, c_idx, upd_log_weight, u):
        """The strata whose ancestors differ, each required to sit on a
        cumulative-weight boundary. Returns their rows."""
        import torch
        g_idx, c_idx = g_idx.cpu().long(), c_idx.cpu().long()
        differ = (g_idx != c_idx).nonzero()[:, 0]
        P = u.shape[0]
        cum = torch.cumsum(torch.exp(upd_log_weight.double().cpu()), 0)
        for j in differ.tolist():
            point = (j + float(u[j])) / P
            if float((cum - point).abs().min()) >= 1e-4:
                raise AssertionError(f"stratum {j} took another ancestor "
                                     "away from a cumulative-weight "
                                     "boundary")
        return differ

    def check(self, got_state, got_out, want_state, want_out, updated, u):
        """Hold one step (``updated``: the 1-process step's log weights as
        its resampling read them); returns (bits, strata moved, slots
        swapped)."""
        import torch

        from ..slam import PER_PARTICLE_OUTPUTS
        from .sharding import particle_leaves
        if bool(got_out.resampled) != bool(want_out.resampled):
            raise AssertionError("the resampling decision differs")
        if int(got_out.overflow) != int(want_out.overflow):
            raise AssertionError(f"overflow {int(got_out.overflow)} != "
                                 f"{int(want_out.overflow)}")
        self.close("n_eff", got_out.n_eff, want_out.n_eff)
        self.close("expected_pose", got_out.expected_pose,
                   want_out.expected_pose)
        self.close("map weights (sorted)",
                   torch.sort(got_out.map_weight).values,
                   torch.sort(want_out.map_weight).values)
        fields = [f for f in want_out._fields
                  if f not in PER_PARTICLE_OUTPUTS
                  and getattr(want_out, f) is not None]
        swapped = 0
        for f in fields:
            g, w = getattr(got_out, f)[None], getattr(want_out, f)[None]
            if f == "cardinality":
                self.log_card(g.cpu(), w.cpu())
            elif f in ("map_mean", "map_cov", "map_cloud"):
                swapped += self.slots(f, got_out.map_weight[None], g,
                                      want_out.map_weight[None], w)
        moved = self.strata(got_state.resample_idx, want_state.resample_idx,
                            updated, u)
        keep = torch.ones(want_state.log_weight.shape[0], dtype=torch.bool)
        keep[moved] = False
        got = dict(particle_leaves(got_state))
        want = dict(particle_leaves(want_state))
        bits = len(moved) == 0 and all(
            torch.equal(got[p].cpu(), want[p].cpu()) for p in want) \
            and all(torch.equal(getattr(got_out, f).cpu(),
                                getattr(want_out, f).cpu()) for f in fields)
        for p, w in want.items():
            g, w = got[p].cpu()[keep], w.cpu()[keep]
            name = ".".join(p)
            if p == ("resample_idx",):
                continue
            if p == ("cardinality",):
                self.log_card(g, w)
            elif p[-1] in ("mean", "cov", "cloud"):
                # a map slot's payload, held beside its weight
                wp = (("feat_weight",) if p[-1] == "cloud"
                      else p[:-1] + ("weight",))
                swapped += self.slots(name, got[wp].cpu()[keep], g,
                                      want[wp].cpu()[keep], w)
            else:
                self.close(name, g, w)
        return bits, len(moved), swapped

    def log_card(self, got, want):
        import torch
        got, want = got.double(), want.double()
        peak = want.amax(dim=1, keepdim=True)
        near = want > peak - 60.0
        self.close("cardinality", got[near], want[near])
        if not bool(((got - peak)[~near] < -50.0).all()):
            raise AssertionError("cardinality tail differs")


def gated_task(task, mesh):
    """Step the sharded runner and hold every step to the 1-process step
    (the runner's own step without a mesh) from the same (gathered) state
    and draws (:class:`Gate`); resync to the 1-process state after a step
    whose ancestry moved at a boundary.
    ``launches``: the sharded steps' kernel launches on this rank (the
    1-process steps' not counted)."""
    import collections

    import torch

    from .sharding import shard_state
    cfg = build_cfg(task)
    runner = build_runner(task, cfg, mesh)
    gate = Gate()
    steps = min(task["steps"], runner.n_steps)
    bits = resyncs = strata = swapped = resampled = 0
    launches = collections.Counter()
    mesh.stats.reset()
    t0 = time.perf_counter()
    for n in range(steps):
        noise = _replayable(runner.noise())
        want, want_out, updated = runner.step_state(
            runner.global_state(), n, noise, return_updated=True)
        out, made = _launched_by(runner.step, n, runner.local_noise(noise))
        launches.update(made)
        b, m, s = gate.check(runner.global_state(), out, want, want_out,
                             updated, noise.u_resample)
        bits += b
        strata += m
        swapped += s
        resampled += bool(out.resampled)
        moved = mesh.all_max(torch.tensor([m], device=mesh.device))
        if int(moved):
            runner.state = shard_state(mesh, want)
            resyncs += 1
    wall = time.perf_counter() - t0
    return {"steps": steps, "bit_equal_steps": bits, "resyncs": resyncs,
            "strata_moved": strata, "slots_swapped": swapped,
            "resampled_steps": resampled, "max_err": gate.max_err,
            "wall_s": wall, "launches": dict(launches),
            "migrations": dict(mesh.stats.migrations),
            "migration_bytes": dict(mesh.stats.migration_bytes),
            "collective_calls": dict(mesh.stats.calls),
            "collective_bytes": dict(mesh.stats.bytes)}, None


def run_task(task, mesh):
    """A free-running sharded run: ``steps`` (the schedule's length by
    default), checkpointed at its end into ``save`` or resumed from
    ``resume``; with ``score``, scored as ``eval/parity.py::
    evaluate_dataset`` scores it. Arrays: est_poses, n_eff, resampled."""
    cfg = build_cfg(task)
    if task.get("steps"):
        cfg.n_steps = task["steps"]
    collective_timing = bool(task.get("collective_timing"))
    mesh.stats.timing = collective_timing
    _reset_counts()
    mesh.stats.reset()
    if task.get("score"):
        from ..eval.parity import evaluate_dataset
        r = evaluate_dataset(task["cfg"], ".", n_steps=task.get("steps"),
                             overrides=task.get("overrides"),
                             device=mesh.device, mesh=mesh)
        res = r["run"]
        extra = {k: r[k] for k in ("mean_pose_err", "max_pose_err",
                                   "mean_ospa", "final_ospa")}
    else:
        # the global state restored, then sharded by run_sharded
        runner = build_runner(task, cfg, None, mesh.device)
        start = runner.restore(task["resume"]) if task.get("resume") else 0
        chunk = task.get("chunk", 64)
        res = runner.run_sharded(
            mesh, chunk=chunk, start_step=start,
            checkpoint_every=chunk if task.get("save") else 0,
            checkpoint_dir=task.get("save"))
        extra = {}
    extra.update(
        steps=len(res["n_eff"]) - res["start_step"],
        steps_per_s=res["steps_per_s"], wall_s=res["wall_s"],
        overflow=res["overflow"], nan_step=res["nan_step"],
        n_devices=res["n_devices"], launches=_counts(),
        migrations=dict(mesh.stats.migrations),
        migration_bytes=dict(mesh.stats.migration_bytes),
        collective_calls=dict(mesh.stats.calls),
        collective_bytes=dict(mesh.stats.bytes),
        collective_ms=dict(mesh.stats.ms))
    arrays = {k: res[k] for k in ("est_poses", "n_eff", "resampled")}
    return extra, arrays


def replay_task(task, mesh):
    """Recorded inputs and global draws (``npz``: the initial state under
    ``types.state_to_numpy``'s keys with prefix "s0_", per-step z, z_mask,
    control, dt, do_predict, eps_pred, u_resample; eps_sample for the
    disparity step) through the sharded step; arrays: every step's
    gathered state, prefixed "step<n>_", and its outputs. Where the record
    holds the state before step n (prefix "s<n>_"), step n starts from it
    (each step held from the recorded state, not from the port's last)."""
    import torch

    from .. import types
    from ..filters import phd
    from ..filters.disparity import DisparityNoise
    from ..filters.phd import StepNoise
    from ..slam import PER_PARTICLE_OUTPUTS
    from .sharding import (gather_state, make_sharded_disparity_step_fn,
                           make_sharded_step_fn, shard_state)
    cfg = build_cfg(task)
    dev = mesh.device
    with np.load(task["npz"]) as z:
        rec = {k: z[k] for k in z.files}
    disparity = "eps_sample" in rec

    def t(x):
        return torch.as_tensor(x, device=dev)

    def recorded(n):
        s = {k[len(f"s{n}_"):]: v for k, v in rec.items()
             if k.startswith(f"s{n}_")}
        if not s:
            return None
        load = (types.disparity_state_from_jax if disparity
                else types.state_from_jax)
        return shard_state(mesh, load(s, device=dev))
    step = (make_sharded_disparity_step_fn(cfg, mesh) if disparity
            else make_sharded_step_fn(cfg, mesh))
    # the tiled-or-untiled choices of the merges: "tiled", "untiled" (a
    # tile above the widest tile row) and "narrow" (candidate width < 256)
    tiles = collections.Counter()
    real_tile_width = phd.tile_width

    def tile_width(N, n_tile):
        ct = real_tile_width(N, n_tile)
        tiles["tiled" if ct else "untiled" if N >= 256 else "narrow"] += 1
        return ct
    arrays = {}
    with mock.patch.object(phd, "tile_width", tile_width):
        for n in range(len(rec["dt"])):
            start = recorded(n)
            state = state if start is None else start
            z_n, zm = t(rec["z"][n]), t(rec["z_mask"][n])
            dt, dp = float(rec["dt"][n]), bool(rec["do_predict"][n])
            if disparity:
                noise = DisparityNoise(t(rec["eps_pred"][n]),
                                       t(rec["eps_sample"][n]),
                                       t(rec["u_resample"][n]))
                state, out = step(state, z_n, zm, dt, dp, noise)
                got = types.disparity_state_to_numpy(
                    gather_state(mesh, state))
            else:
                noise = StepNoise(t(rec["eps_pred"][n]),
                                  t(rec["u_resample"][n]))
                ctl = tuple(float(c) for c in rec["control"][n])
                state, out = step(state, z_n, zm, ctl, dt, dp, noise)
                got = types.state_to_numpy(gather_state(mesh, state))
            for k, v in got.items():
                arrays[f"step{n}_{k}"] = v
            for k, v in out._asdict().items():
                if v is not None:
                    if k in PER_PARTICLE_OUTPUTS:
                        v = mesh.all_gather(v)
                    arrays[f"step{n}_out_{k}"] = v.cpu().numpy()
    return {"steps": len(rec["dt"]),
            "migrations": dict(mesh.stats.migrations),
            "tile_counts": dict(tiles)}, arrays


TASKS = {"gated": gated_task, "run": run_task, "replay": replay_task}


# ----------------------------------------------------------------------------
# the command line: the JAX harness's scene
# ----------------------------------------------------------------------------

SMALL_FIELDS = dict(
    max_features=12, max_measurements=4, motion_type=0, feature_model=0,
    filter_type=0, max_range=15.0, std_range=0.25, std_bearing=0.02,
    clutter_rate=5.0, pd=0.95, birth_weight=0.05, min_separation=2.0,
    resample_threshold=1.0, seed=3)
SMALL_Z = [[5.0, 0.1], [8.0, -0.4], [3.0, 1.0]]
DISPARITY_FIELDS = dict(
    max_features=8, max_measurements=8, particles_per_feature=16,
    motion_type=0, filter_type=0, pd=0.9, clutter_rate=2.0,
    birth_weight=0.05, min_separation=8.0, fx=500.0, fy=500.0, u0=320.0,
    v0=240.0, image_width=640, image_height=480, std_u=1.0, std_v=1.0,
    disparity_birth=100.0, std_d_birth=30.0, vx0=0.25, dt=1.0,
    resample_threshold=1.1, seed=5)


def small_task(particles: int, steps: int, disparity: bool, tmp: str):
    """The JAX harness's scenes as a task: the 2D map with three fixed
    measurements a step, or (``disparity``) the SC-PHD filter on eight
    fixed image points, resampling forced on every step."""
    if not disparity:
        return {"runner": "scan", "fields": dict(SMALL_FIELDS,
                                                 n_particles=particles),
                "fixed": SMALL_Z, "steps": steps, "dt": 0.1}
    from ..eval.simdata import write_disparity_run_dir
    rng = np.random.default_rng(2)
    z = rng.uniform([100, 100], [540, 380], (8, 2)).astype(np.float32)
    data = os.path.join(tmp, "disparity")
    write_disparity_run_dir(data, [z] * steps)
    return {"runner": "disparity", "data": data, "steps": steps,
            "fields": dict(DISPARITY_FIELDS, n_particles=particles,
                           data_directory=data)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="phdslam_tpu_torch.parallel.sim")
    ap.add_argument("--child", nargs=2, metavar=("RANK", "SPEC"))
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--particles", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="default: nccl on cuda, gloo on the cpu")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="wall limit of each process group (s)")
    ap.add_argument("--disparity", action="store_true",
                    help="the SC-PHD disparity filter (cloud-state "
                         "sharding and migration)")
    ap.add_argument("--ckpt-test", action="store_true",
                    help="save from 2 ranks halfway, resume on --nproc "
                         "ranks, hold against the uninterrupted 1-process "
                         "run")
    args = ap.parse_args(argv)
    if args.child:
        _child(int(args.child[0]), args.child[1])
        return 0
    kw = dict(device=args.device, backend=args.backend,
              timeout_s=args.timeout)
    with tempfile.TemporaryDirectory(prefix="sim_data_") as tmp:
        task = small_task(args.particles, args.steps, args.disparity, tmp)
        if args.ckpt_test:
            return _ckpt_test(task, args, kw, tmp)
        res = run_group(args.nproc, dict(task, kind="gated"), **kw)[0]
    ok = res["resampled_steps"] > 0
    print(f"{args.nproc}-process sharded steps vs the 1-process step on "
          f"the same states and draws: {res['steps']} steps within the "
          f"gates, {res['bit_equal_steps']} bit-equal, {res['resyncs']} "
          f"resyncs, max |diff| {res['max_err']:.3g}, transport "
          f"{res['transport']} -> {'PARITY' if ok else 'MISMATCH'}")
    print(json.dumps({"metric": "multiprocess_parity", "parity": ok,
                      "nproc": args.nproc, **{k: res[k] for k in (
                          "steps", "bit_equal_steps", "resyncs", "max_err",
                          "resampled_steps", "migrations", "transport")}}))
    return 0 if ok else 1


def _ckpt_test(task, args, kw, tmp):
    half = max(2, args.steps // 2)
    steps = 2 * half
    ckpt = os.path.join(tmp, "ckpt")
    run = dict(task, kind="run", chunk=half)
    run_group(2, dict(run, steps=half, save=ckpt), **kw)
    resumed = run_group(args.nproc, dict(
        run, steps=steps, resume=os.path.join(ckpt, f"step{half:05d}")),
        **kw)[0]["arrays"]
    # the uninterrupted run in this process, without a group
    spec = dict(run, steps=steps)
    cfg = build_cfg(spec)
    cfg.n_steps = steps
    ref = build_runner(spec, cfg, None, args.device).run(chunk=half)
    got, want = resumed["est_poses"][half:], ref["est_poses"][half:]
    ok = np.allclose(got, want, rtol=1e-4, atol=1e-5) and np.array_equal(
        resumed["resampled"][half:], ref["resampled"][half:])
    bits = bool(np.array_equal(got, want))
    err = float(np.abs(got - want).max())
    print(f"2-rank checkpoint at step {half} -> {args.nproc}-rank resume "
          f"vs the uninterrupted 1-process run: max pose |diff| {err:.3g}, "
          f"bit-equal {bits} -> {'PARITY' if ok else 'MISMATCH'}")
    print(json.dumps({"metric": "multiprocess_ckpt_resume_parity",
                      "parity": bool(ok), "nproc": args.nproc,
                      "pose_maxdiff": err, "bit_equal": bits}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
