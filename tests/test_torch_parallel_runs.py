"""Multi-process runs of the port's sharded filter on the CPU
(``phdslam_tpu_torch/parallel/sim.py``: Gloo ranks over a ``file://``
store, each group under a wall limit).

The sharded step keeps the unsharded reductions' order (every rank
reduces the gathered O(P) scalars as one process would), so a sharded run
is the unsharded run bit for bit where each rank's per-particle work is
too. On the CPU that needs blocks of 8 particles or a multiple: PyTorch's
vectorized CPU loops take two SIMD vectors (32 floats) an iteration and
finish a tensor's remainder in scalar code, whose transcendental functions
(atan2 in the bearing, exp, log) round differently by one ulp, so an
element's bits depend on its place in the tensor (a [4, 12] block ends in
a scalar tail where the [16, 12] batch does not). Every case here holds
the sharded steps to the 1-process steps from the same states and draws
and requires all of them bit-equal, with the migration's neighbour
exchange and its full-gather fallback both taken. The whole slice: ``python -m
phdslam_tpu_torch ... --distributed`` on two ranks writes the 1-process
CLI's state logs byte for byte, and its checkpoint resumes on four.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from phdslam_tpu_torch.__main__ import main
from phdslam_tpu_torch.eval import batch
from phdslam_tpu_torch.parallel.sim import SMALL_FIELDS, SMALL_Z, run_group
from phdslam_tpu_torch.slam import SynthSLAMRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (2, 4)
STEPS = 5
MIXED_COVS = dict(cov_vx_birth=0.25, cov_vy_birth=0.25, std_ax_map=0.01,
                  std_ay_map=0.01)
# the small scene of the JAX harness (resampling forced on every step)
VARIANTS = {
    "plain": {},
    "cphd": dict(filter_type=1, max_cardinality=24),
    "mixed": dict(feature_model=2, **MIXED_COVS),
    "mixed_velinit": dict(feature_model=2, birth_velocity_init=1,
                          **MIXED_COVS),
    "eap": dict(map_estimate=2),
    # blocks of 24: no local tree levels, the planes gathered
    "eap_block24": dict(map_estimate=2, block=24),
    "shotgun": dict(n_predict_particles=2),
    "variance": dict(compute_variance=True),
    "eap_shotgun_cphd": dict(map_estimate=2, n_predict_particles=2,
                             filter_type=1, max_cardinality=24),
}


def scene_task(size, block=8, **kw):
    return {"kind": "gated", "runner": "scan", "fixed": SMALL_Z,
            "steps": STEPS, "dt": 0.1,
            "fields": dict(SMALL_FIELDS, n_particles=block * size,
                           resample_threshold=1.1, **kw)}


def disparity_task(size, tmp):
    from phdslam_tpu_torch.eval.simdata import write_disparity_run_dir
    from phdslam_tpu_torch.parallel.sim import DISPARITY_FIELDS
    rng = np.random.default_rng(2)
    z = rng.uniform([100, 100], [540, 380], (8, 2)).astype(np.float32)
    data = str(tmp / "disparity")
    write_disparity_run_dir(data, [z] * STEPS)
    return {"kind": "gated", "runner": "disparity", "data": data,
            "steps": STEPS, "fields": dict(DISPARITY_FIELDS,
                                           n_particles=8 * size,
                                           data_directory=data)}


@pytest.fixture(scope="module")
def gated(tmp_path_factory):
    """Every variant and the disparity scene, gated step by step, in one
    group per mesh size."""
    out = {}
    for size in SIZES:
        tmp = tmp_path_factory.mktemp(f"gated{size}")
        names = list(VARIANTS) + ["disparity"]
        tasks = [scene_task(size, **VARIANTS[n]) for n in VARIANTS] \
            + [disparity_task(size, tmp)]
        res = run_group(size, {"kind": "each", "tasks": tasks},
                        device="cpu", timeout_s=240)
        assert {r["transport"] for r in res} == {"gloo"}
        out[size] = dict(zip(names, res[0]["results"]))
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("variant", list(VARIANTS) + ["disparity"])
def test_sharded_steps_bit_equal_to_one_process(gated, size, variant):
    """Each sharded step equals the 1-process step from the same state and
    draws, bit for bit; resampling ran, through the neighbour exchange on
    four ranks where it is feasible (the full gather on two ranks, and for
    shotgunning's contraction)."""
    r = gated[size][variant]
    assert r["steps"] == STEPS
    assert r["bit_equal_steps"] == STEPS, r
    assert r["resyncs"] == 0 and r["strata_moved"] == 0, r
    assert r["resampled_steps"] >= STEPS - 1, r
    route = "neighbour" if size > 2 and "shotgun" not in variant \
        else "full"
    assert r["migrations"].get(route, 0) > 0, r


def dense_task(budget):
    """tests/test_sharding.py's dense-flavoured shape: P=256, K=256, M=48
    (40 live), cap 384, T=32, EAP, resampling forced on every step."""
    rng = np.random.default_rng(0)
    M = 48
    z = np.column_stack([rng.uniform(1, 14, M),
                         rng.uniform(-3, 3, M)]).astype(np.float32)
    fields = dict(n_particles=256, max_features=256, max_measurements=M,
                  motion_type=1, feature_model=0, filter_type=0, l=2.83,
                  h=0.76, a=3.78, b=0.5, std_encoder=0.1, std_alpha=0.01,
                  max_range=15.0, std_range=0.5, std_bearing=0.0349,
                  clutter_rate=20.0, pd=0.95, birth_weight=0.05,
                  min_separation=5.0, min_feature_weight=1e-6,
                  merge_candidate_cap=384, detection_topk=32,
                  map_estimate=2, resample_threshold=1.1, seed=0,
                  migration_row_budget=budget)
    return {"kind": "gated", "runner": "scan", "fixed": z[:40].tolist(),
            "steps": 4, "dt": 1.0, "fields": fields}


def test_dense_shape_sharded_bit_equal():
    """The dense-flavoured shape on four ranks, with the default row budget
    (the neighbour exchange) and a budget of one row (infeasible: the full
    gather), every step bit-equal to the 1-process step."""
    res = run_group(4, {"kind": "each", "tasks": [dense_task(0),
                                                  dense_task(1)]},
                    device="cpu", timeout_s=240)[0]["results"]
    for r, route in zip(res, ("neighbour", "full")):
        assert r["bit_equal_steps"] == r["steps"] == 4, r
        assert r["migrations"].get(route, 0) >= 3, r
        assert route == "full" or "full" not in r["migrations"], r


# ----------------------------------------------------------------------------
# the runner, the command line and checkpoints across process counts
# ----------------------------------------------------------------------------

CFG_TEXT = ("motion_type = 1\nn_particles = 8\nmax_features = 16\n"
            "max_measurements = 16\nl = 2.83\nh = 0.76\na = 3.78\n"
            "b = 0.5\nstd_encoder = 2\nstd_alpha = 0.0873\n"
            "max_range = 10\nstd_range = 1\nstd_bearing = 0.0349\n"
            "clutter_rate = 20\npd = 0.95\nparticle_weighting = 0\n"
            "filter_type = 0\nresample_threshold = 0.9\nn_steps = 12\n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch")
    batch.generate_batch_datasets(str(root), n_runs=1, n_landmarks=15,
                                  n_steps=30, seed=3)
    cfg = root / "t.cfg"
    cfg.write_text(CFG_TEXT + f"data_directory = {root}/run000\n")
    return root, str(cfg)


def logs(out_dir):
    return sorted(f for f in os.listdir(out_dir)
                  if f.startswith("state_estimate"))


def same_logs(a, b, names):
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_cli_distributed_matches_one_process(dataset, tmp_path):
    """``--distributed`` on two Gloo ranks (checkpoints every 6 steps) writes
    the 1-process CLI's 12 state logs byte for byte, only rank 0 writing;
    its step-6 checkpoint resumed on four ranks writes steps 6-11 as the
    uninterrupted run did."""
    root, cfg = dataset
    one, two, four = (str(tmp_path / d) for d in ("one", "two", "four"))
    args = ["--chunk", "6", "--checkpoint-every", "6"]
    assert main([cfg, "--out-dir", one, *args], device="cpu") == 0
    res = run_group(2, {"kind": "cli", "argv": [
        cfg, "--out-dir", two, *args, "--distributed"]}, device="cpu",
        timeout_s=180)
    assert [r["rc"] for r in res] == [0, 0]
    assert logs(one) == logs(two) and len(logs(one)) == 12
    same_logs(one, two, logs(one) + ["config.cfg"])
    assert sorted(os.listdir(os.path.join(two, "checkpoints"))) == [
        "step00006", "step00012"]
    res = run_group(4, {"kind": "cli", "argv": [
        cfg, "--out-dir", four, "--chunk", "6", "--distributed",
        "--resume", os.path.join(two, "checkpoints", "step00006")]},
        device="cpu", timeout_s=180)
    assert [r["rc"] for r in res] == [0] * 4
    resumed = logs(four)
    assert resumed == logs(one)[6:]
    same_logs(one, four, resumed)


CLI_RANK = """
import sys
import torch.distributed as dist
from phdslam_tpu_torch.__main__ import main
assert main(sys.argv[1:], device="cpu") == 0
assert not dist.is_initialized()        # the command's group ended with it
"""


def test_cli_under_a_launcher_environment(dataset, tmp_path):
    """``--distributed`` under torchrun's environment (a localhost TCP
    store): the command initializes the group, runs the sharded loop,
    rank 0 writes the logs the 1-process CLI writes, and the group ends
    with the command."""
    import socket
    root, cfg = dataset
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert main([cfg, "--out-dir", one, "--steps", "6"], device="cpu") == 0
    script = tmp_path / "rank.py"
    script.write_text(CLI_RANK)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen(
        [sys.executable, str(script), cfg, "--out-dir", two, "--steps", "6",
         "--distributed"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "process 1/2, 2 global devices" in "".join(outs)
    assert logs(one) == logs(two) and len(logs(one)) == 6
    same_logs(one, two, logs(one))


def test_run_sharded_matches_unsharded(dataset):
    """``SynthSLAMRunner.run`` on a mesh of two ranks (the JAX version's
    ``run_sharded`` test on its dataset): the same poses, nEff and
    resampling decisions as the 1-process run, bit for bit, and
    n_devices 2."""
    root, cfg = dataset
    from phdslam_tpu_torch import load_config
    ref = SynthSLAMRunner(load_config(cfg), device="cpu").run()
    res = run_group(2, {"kind": "run", "runner": "synth", "cfg": cfg},
                    device="cpu", timeout_s=180)
    got = res[0]["arrays"]
    assert res[0]["n_devices"] == 2
    for k in ("est_poses", "n_eff", "resampled"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("args", [
    ["--nproc", "2", "--steps", "6"],
    ["--nproc", "4", "--steps", "5", "--disparity"],
    ["--nproc", "4", "--steps", "6", "--ckpt-test"],
], ids=["two", "disparity4", "ckpt2to4"])
def test_sim_command_line(args):
    """``python -m phdslam_tpu_torch.parallel.sim``: PARITY, exit 0."""
    r = subprocess.run([sys.executable, "-m",
                        "phdslam_tpu_torch.parallel.sim", "--device", "cpu",
                        *args],
                       capture_output=True, text=True, timeout=240,
                       cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "PARITY" in r.stdout
