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
first launches. Then the CPHD cardinality prediction alone
(``filters/cphd.py::cardinality_predict_batch`` at the CPHD path's C1 = 65,
``PREDICT_ROWS`` rows of random log distributions from a seed) prints one
line a row count: ms per eager call, host included (``call_ms``), and the
device ms of calls replayed from a CUDA graph (``graph_ms``), with a
digest of its output (the same inputs in every checkout).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

from gather_bench import bench_parser, graph_ms, open_checkout, time_call

# name: (configuration, particles, steps (None: the whole dataset),
# overrides)
STEPS_CASES = {
    "cphd P=512": ("cfg/ackerman_cphd.cfg", 512, None, {}),
    "cphd P=10240": ("cfg/ackerman_cphd.cfg", 10240, 60, {}),
    "dense full grid P=1024": ("cfg/dense.cfg", 1024, 30,
                               {"merge_candidate_cap": 0}),
}
# the cardinality prediction's row counts: the CPHD paths' P
PREDICT_ROWS, PREDICT_C1 = (512, 10240), 65


def predict_lines(args, card):
    """One JSON line a row count of PREDICT_ROWS: the prediction's time per
    eager call and on the device, and its output's digest."""
    from phdslam_tpu_torch.filters.cphd import cardinality_predict_batch
    for P in PREDICT_ROWS:
        name = f"cardinality_predict_batch P={P}"
        if args.only not in name:
            continue
        rng = np.random.default_rng(P)
        log_cn = torch.from_numpy(rng.uniform(
            -60, 0, (P, PREDICT_C1)).astype(np.float32)).cuda()
        log_b = torch.from_numpy(rng.uniform(
            -40, 0, PREDICT_C1).astype(np.float32)).cuda()

        def fn(log_cn=log_cn, log_b=log_b):
            return cardinality_predict_batch(log_cn, log_b)
        out = fn().cpu().numpy()
        print(json.dumps({
            "label": args.label, "case": name, "C1": PREDICT_C1,
            "call_ms": min(time_call(fn) for _ in range(2)),
            "graph_ms": graph_ms(fn),
            "out_sha": hashlib.sha256(out.tobytes()).hexdigest()[:32],
            "card": card}), flush=True)


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
    predict_lines(args, card)


if __name__ == "__main__":
    sys.exit(main())
