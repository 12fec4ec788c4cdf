"""Command line (port of ``phdslam_tpu/__main__.py``):

    python -m phdslam_tpu_torch <config.cfg> [synth|disparity] [options]

* positional 1: config file path
* positional 2: run type (default ``synth``; ``disparity`` runs the
  monocular SC-PHD filter)
* ``--profile CHECKPOINT``: load a checkpoint and time a single
  measurement update

Outputs go to ``--out-dir`` (default: a timestamped directory under
``runs/``): ``state_estimateXXXXX.log`` per step, ``loopTime.log``
(``predicttime.log`` with ``--timing``; ``trajectory.txt`` for
``disparity``), a copy of the config, and with ``--checkpoint-every`` the
``checkpoints/stepNNNNN`` directories that ``--resume`` takes.

The JAX version's ``--runner chunked|scanned|async`` are dispatch
strategies for its TPU; here all three run the one step loop
(``slam.py::_Runner.run``), in chunks of ``--chunk`` steps. ``--resume``
is still refused without ``--runner chunked`` (and with ``--timing``,
which the JAX version runs on its per-step runner), so scripts behave
alike on both packages. ``--replay`` needs matplotlib.

``--distributed`` under a launcher (``torchrun --nproc-per-node N -m
phdslam_tpu_torch ...``; NCCL, one GPU per rank, on the card) splits the
particle axis over the ranks (``parallel/``): every rank runs its block,
and the primary (rank 0) writes the logs, checkpoints and artifacts.
Without a launcher it runs the one-process path, as the JAX version's
does.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import time


def main(argv=None, device="cuda"):
    """Run the command line ``argv`` on ``device`` (the card by default;
    the tests pass "cpu"). Returns the exit code."""
    ap = argparse.ArgumentParser(prog="phdslam_tpu_torch")
    ap.add_argument("config", help="config file path")
    ap.add_argument("run_type", nargs="?", default="synth",
                    choices=["synth", "disparity"])
    ap.add_argument("--profile", metavar="CHECKPOINT",
                    help="load checkpoint and run a single update")
    ap.add_argument("--out-dir", default=None,
                    help="output directory (default: timestamped)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--runner", default="chunked",
                    choices=["chunked", "scanned", "async"],
                    help="accepted for the JAX version's scripts: every "
                         "runner is the one step loop")
    ap.add_argument("--chunk", type=int, default=64,
                    help="steps between waits for the card (loopTime.log "
                         "granularity, checkpoint boundaries)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint every N steps during the run, at the "
                         "first chunk boundary reaching each multiple")
    ap.add_argument("--resume", metavar="CHECKPOINT", default=None,
                    help="resume a chunked run from a mid-run checkpoint "
                         "written by --checkpoint-every")
    ap.add_argument("--timing", action="store_true",
                    help="wait for the card after every step: per-step "
                         "loopTime.log + predicttime.log")
    ap.add_argument("--replay", default=None,
                    choices=["png", "gif", "mp4"],
                    help="write a replay artifact (4-panel frames: map, "
                         "particles, weights, cardinality) + the "
                         "weight-inspector figure (needs matplotlib)")
    ap.add_argument("--replay-every", type=int, default=10,
                    help="replay frame stride")
    ap.add_argument("--debug", action="store_true",
                    help="check every step for NaN weights and raise "
                         "FloatingPointError at the first")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the run "
                         "(DIR/trace.json) and its spans and counters "
                         "(DIR/spans.json)")
    ap.add_argument("--distributed", action="store_true",
                    help="run on every process of a torch.distributed "
                         "group (torchrun; the same command on every "
                         "rank): the particle axis split over the ranks")
    args = ap.parse_args(argv)

    mesh = owned_group = None
    if args.distributed:
        import torch.distributed as dist

        from .parallel import distributed
        owned_group = not dist.is_initialized()
        if distributed.initialize(device=device):
            mesh = distributed.global_mesh(device)
            device = mesh.device
            print(f"multi-process runtime: process {dist.get_rank()}/"
                  f"{dist.get_world_size()}, {mesh.size} global devices")
    primary = mesh is None or mesh.rank == 0
    # the JAX version times with its per-step runner, which cannot resume
    runner_kind = "async" if args.timing else args.runner
    if args.resume and runner_kind != "chunked":
        ap.error("--resume requires --runner chunked "
                 "(start_step is only honored there)")

    from .config import load_config
    cfg = load_config(args.config)
    if args.steps is not None:
        cfg.n_steps = args.steps
    if args.particles is not None:
        cfg.n_particles = args.particles

    out_dir = args.out_dir
    if out_dir is None:
        out_dir = os.path.join("runs", time.strftime("%Y%m%d-%H%M%S"))
    if primary:
        os.makedirs(out_dir, exist_ok=True)
        shutil.copy(args.config, os.path.join(out_dir, "config.cfg"))

    from .runtime import profiling
    ctx = contextlib.ExitStack()
    if args.debug:
        ctx.enter_context(profiling.debug_mode())
    if args.trace and primary:
        ctx.enter_context(profiling.trace(args.trace))
    if owned_group and dist.is_initialized():
        # the group this command initialized ends with it
        ctx.callback(dist.destroy_process_group)

    with ctx:
        if args.run_type == "disparity":
            from .slam_disparity import run_disparity
            res = run_disparity(cfg, out_dir=out_dir, timing=args.timing,
                                chunk=args.chunk, device=device, mesh=mesh)
        elif args.profile:
            from .runtime.checkpoint import profile_single_update
            res = profile_single_update(cfg, args.profile, device=device)
        else:
            from .slam import SynthSLAMRunner
            runner = SynthSLAMRunner(cfg, device=device, mesh=mesh)
            start_step = 0
            if args.resume:
                start_step = runner.restore(args.resume)
                print(f"resumed from {args.resume} at step {start_step}")
            res = runner.run(
                out_dir=out_dir, chunk=args.chunk, timing=args.timing,
                checkpoint_every=args.checkpoint_every,
                checkpoint_dir=(os.path.join(out_dir, "checkpoints")
                                if args.checkpoint_every else None),
                start_step=start_step)
            if args.replay and primary:
                write_replay(res, cfg, out_dir, args.replay,
                             args.replay_every)

    if primary:
        print(f"done: {len(res['est_poses'])} steps "
              f"{res.get('steps_per_s', 0):.2f} steps/s -> {out_dir}")
    return 0


def write_replay(res, cfg, out_dir, fmt, every):
    """The replay artifact under ``out_dir/replay`` and ``weights.png``
    (ground truth drawn when the dataset has ``groundtruth.npz``)."""
    import numpy as np

    from .eval.plots import animate_run, plot_weight_inspector
    gt = None
    gt_path = os.path.join(cfg.data_directory, "groundtruth.npz")
    if os.path.exists(gt_path):
        gt = dict(np.load(gt_path))
    art = animate_run(res, os.path.join(out_dir, "replay"), gt=gt, fmt=fmt,
                      every=every)
    plot_weight_inspector(res["log_weights"],
                          os.path.join(out_dir, "weights.png"))
    if fmt == "png":
        art = os.path.dirname(art[0])
    print(f"replay artifact: {art}")


if __name__ == "__main__":
    raise SystemExit(main())
