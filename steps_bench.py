"""Steps a second, accuracy and peak device memory of the port's paths.

    python3 steps_bench.py [--root DIR] [--label NAME] [--only TEXT]
                           [--runs N]

Needs one NVIDIA GPU; imports no jax. ``phdslam_tpu_torch`` is imported
from DIR (default: the directory of this script), with DIR's configurations
and data, so that two checkouts can
be set side by side on one card in one call, as with ``merge_bench.py``:
unpack the other into a directory that ``.gitignore`` lists and run
parent, change, change, parent.

Each case (``STEPS_CASES``: a configuration, its particle count, its steps
and overrides) runs ``N`` times (default 2) through
``eval/parity.py::evaluate_dataset`` on the card, and each run prints one
JSON line: steps a second and wall seconds of the runner's loop, the peak
device memory allocated during the run (MiB), mean ATE (m) and mean
every-step OSPA(1, 5). The first run of a process includes the kernels'
first launches.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from gather_bench import bench_parser, open_checkout

# name: (configuration, particles, steps (None: the whole dataset),
# overrides)
STEPS_CASES = {
    "cphd P=512": ("cfg/ackerman_cphd.cfg", 512, None, {}),
    "cphd P=10240": ("cfg/ackerman_cphd.cfg", 10240, 60, {}),
    "dense full grid P=1024": ("cfg/dense.cfg", 1024, 30,
                               {"merge_candidate_cap": 0}),
}


def main():
    ap = bench_parser(__doc__)
    ap.add_argument("--only", default="", help="run only the cases whose "
                    "name holds this text")
    ap.add_argument("--runs", type=int, default=2, help="runs of each case")
    args = ap.parse_args()
    card = open_checkout("steps_bench.py", args.root)
    from phdslam_tpu_torch.eval.parity import evaluate_dataset
    for name, (cfg, P, steps, over) in STEPS_CASES.items():
        if args.only not in name:
            continue
        for i in range(args.runs):
            torch.cuda.reset_peak_memory_stats()
            res = evaluate_dataset(os.path.join(args.root, cfg), args.root,
                                   n_steps=steps,
                                   overrides=dict(over, n_particles=P),
                                   device="cuda")
            print(json.dumps({
                "label": args.label, "case": name, "run": i,
                "steps": len(res["run"]["n_eff"]),
                "steps_per_s": res["steps_per_s"],
                "wall_s": res["run"]["wall_s"],
                "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                "ate": res["mean_pose_err"], "ospa": res["mean_ospa"],
                "card": card}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
