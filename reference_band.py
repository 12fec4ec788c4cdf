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
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

from phdslam_tpu.eval.parity import evaluate_dataset  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg")
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=INT",
                    help="integer config overrides, e.g. "
                         "merge_candidate_cap=0")
    args = ap.parse_args()
    extra = {k: int(v) for k, v in (kv.split("=", 1) for kv in args.set)}
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
