"""Accuracy band of the JAX reference package on the CPU.

    JAX_PLATFORMS=cpu python reference_band.py cfg/ackerman_cphd.cfg \
        --particles 512 --seeds 0 1 2 [--steps N] \
        [--set merge_candidate_cap=0]

Runs ``phdslam_tpu.eval.parity.evaluate_dataset`` (the JAX package's
dataset protocol: mean ATE over the measurement steps, OSPA(1, 5) of the
MAP map on every measurement step) once per seed with the configuration's
other settings unchanged, and prints one line per seed and the mean and
standard deviation over the seeds. The port's accuracy runs
(``chip_smoke.py``) report against this band: both filters draw their own
noise, so only the band, not a bitwise match, applies.

    JAX_PLATFORMS=cpu python reference_band.py cfg/dense.cfg \
        --particles 64 --seeds 0 --replay [--steps N]

    JAX_PLATFORMS=cpu python reference_band.py mixed --particles 256 \
        --seeds 0 1 2 3 4 --set mixed_fast_path=0

``mixed`` in place of a config file runs the JAX package's mixed-world
protocol instead (``phdslam_tpu.eval.parity.evaluate_mixed`` with the
``--set`` values as its cfg_overrides: pose error, static and dynamic
OSPA per seed), the runs ``chip_smoke.py`` sets the port's mixed option
runs beside.

``--replay`` runs the JAX package's step and the port's (its kernels'
plain twins, on the CPU) side by side over the dataset from the same
initial state with JAX's draws, each carrying its own state, and prints
every 20 steps the largest particle pose difference, whether the
resampling ancestors still agree (the pose difference is taken while they
do), and at the end each package's mean ATE over the replayed
measurement steps.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

from phdslam_tpu.eval.parity import evaluate_dataset  # noqa: E402


def replay(cfg_path, P, seed, n_steps, extra):
    """The port against the JAX package on one draw of the noise (see the
    module docstring)."""
    import jax.numpy as jnp
    import torch
    from phdslam_tpu.config import load_config as jax_load_config
    from phdslam_tpu.filters.phd import make_step_fn
    from phdslam_tpu.types import init_state as jax_init_state
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.filters.phd import StepNoise, phd_step
    from phdslam_tpu_torch.slam import SynthSLAMRunner
    from phdslam_tpu_torch.types import state_from_jax

    over = dict(extra, n_particles=P, seed=seed)
    jcfg, tcfg = jax_load_config(cfg_path, over), load_config(cfg_path, over)
    r = SynthSLAMRunner(tcfg, device="cpu")
    traj = np.load(os.path.join(tcfg.data_directory,
                                "groundtruth.npz"))["traj"]
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    g = js.map_static
    ts = state_from_jax({
        "pose": np.asarray(js.pose), "log_weight": np.asarray(js.log_weight),
        "map_mean": np.asarray(g.mean), "map_cov": np.asarray(g.cov),
        "map_weight": np.asarray(g.weight),
        "resample_idx": np.asarray(js.resample_idx),
        "step": np.asarray(js.step)})
    width = 3 if jcfg.motion_type == 0 else 2
    errs, split, d_max = {"jax": [], "port": []}, None, 0.0
    t0 = time.perf_counter()
    for n in range(min(n_steps or r.n_steps, r.n_steps)):
        z, zm, control, dt, do_predict, has_z = r.step_args(n)
        k_pred, k_res, _ = jax.random.split(
            jax.random.fold_in(js.rng, js.step), 3)
        eps = np.stack([np.array(jax.random.normal(
            jax.random.fold_in(k_pred, i), (P, width), dtype=jnp.float32))
            for i in range(max(1, jcfg.subdivide_predict))])
        u = np.array(jax.random.uniform(k_res, (P,), dtype=jnp.float32))
        js, jout = step(js, jnp.asarray(z.numpy()), jnp.asarray(zm.numpy()),
                        jnp.asarray(np.float32(control)), jnp.float32(dt),
                        jnp.asarray(do_predict))
        ts, tout = phd_step(ts, z, zm, control, dt, do_predict, tcfg,
                            StepNoise(torch.from_numpy(eps),
                                      torch.from_numpy(u)), has_z=has_z)
        if split is None:
            d_max = max(d_max, float(np.abs(ts.pose.numpy()
                                            - np.asarray(js.pose)).max()))
            if not np.array_equal(ts.resample_idx.numpy(),
                                  np.asarray(js.resample_idx)):
                split = n
        z_idx = r.schedule[n].z_idx
        if 0 <= z_idx < len(traj):
            for key, pose in (("jax", np.asarray(jout.expected_pose)),
                              ("port", tout.expected_pose.numpy())):
                errs[key].append(float(np.hypot(*(pose[:2]
                                                  - traj[z_idx, :2]))))
        if (n + 1) % 20 == 0:
            state = ("agree" if split is None
                     else f"first differ at step {split}")
            print(f"step {n}: largest particle pose difference {d_max:.3g}"
                  f" in lockstep, ancestors {state}"
                  f", ATE so far JAX {np.mean(errs['jax']):.4f} m, port "
                  f"{np.mean(errs['port']):.4f} m, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    print(f"{cfg_path} {extra} P={P} seed {seed}, {n + 1} steps replayed "
          f"with JAX's draws: mean ATE JAX {np.mean(errs['jax']):.4f} m, "
          f"port {np.mean(errs['port']):.4f} m; largest particle pose "
          f"difference in lockstep {d_max:.3g}; ancestors "
          + ("agree on every step" if split is None
             else f"first differ at step {split}"), flush=True)


def mixed_band(P, seeds, extra):
    """The JAX package's evaluate_mixed over the seeds with the overrides
    ``extra``: one line per seed, then each metric's mean and standard
    deviation over the seeds that have it (a run whose movers all left
    the sensor's range has no dynamic OSPA)."""
    from phdslam_tpu.eval.parity import evaluate_mixed
    keys = ("mean_pose_err", "static_ospa", "dynamic_ospa")
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        r = evaluate_mixed(seed=seed, n_particles=P, cfg_overrides=extra)
        rows.append([float(r[k]) for k in keys])
        print(f"mixed {extra} P={P} seed {seed}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in zip(keys, rows[-1]))
            + f", {time.perf_counter() - t0:.0f} s", flush=True)
    rows = np.asarray(rows)
    print(f"mixed band over seeds {list(seeds)}: " + ", ".join(
        f"{k} {np.nanmean(rows[:, i]):.4f} +- {np.nanstd(rows[:, i]):.4f}"
        for i, k in enumerate(keys)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg")
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=NUM",
                    help="config overrides, e.g. merge_candidate_cap=0 or "
                         "min_separation=0.6")
    ap.add_argument("--replay", action="store_true",
                    help="the port beside JAX on JAX's draws")
    args = ap.parse_args()
    extra = {k: float(v) if "." in v else int(v)
             for k, v in (kv.split("=", 1) for kv in args.set)}
    if args.cfg == "mixed":
        mixed_band(args.particles, args.seeds, extra)
        return
    if args.replay:
        for seed in args.seeds:
            replay(args.cfg, args.particles, seed, args.steps, extra)
        return
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = evaluate_dataset(args.cfg, ".", n_steps=args.steps or None,
                             overrides=dict(extra, n_particles=args.particles,
                                            seed=seed))
        rows.append((r["mean_pose_err"], r["mean_ospa"]))
        print(f"{args.cfg} {extra} P={args.particles} seed {seed}: mean ATE "
              f"{r['mean_pose_err']:.4f} m (max {r['max_pose_err']:.4f}, "
              f"final {r['final_pose_err']:.4f}), mean OSPA(1, 5) "
              f"{r['mean_ospa']:.4f} (final {r['final_ospa']:.4f}), "
              f"{len(r['pose_err'])} measurement steps, "
              f"{time.perf_counter() - t0:.0f} s", flush=True)
    rows = np.asarray(rows)
    print(f"band over seeds {args.seeds}: ATE {rows[:, 0].mean():.4f} +- "
          f"{rows[:, 0].std():.4f} m, OSPA {rows[:, 1].mean():.4f} +- "
          f"{rows[:, 1].std():.4f}", flush=True)


if __name__ == "__main__":
    main()
