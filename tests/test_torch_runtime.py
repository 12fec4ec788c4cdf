"""The port's runtime around the runner against the JAX package: the state
logs and particle dumps (``runtime/io.py``), checkpoint and resume
(``runtime/checkpoint.py``, ``slam.py::_Runner.save`` / ``restore``),
timing and tracing (``runtime/profiling.py``), the NaN policy and the
command line (``python -m phdslam_tpu_torch``), on the CPU.

The command line's whole slice is held against JAX's: both run the batch
fixture's run000 at P=8 for 12 steps, the port on the draws JAX makes
(``tests/test_torch_step.py::replay_noise``: JAX's key for step n is
fold_in(PRNGKey(seed), n), whatever ran before), and every state log of
the port parses equal to JAX's within the step gate.
"""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch

from phdslam_tpu.runtime import io as jio
from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.__main__ import main
from phdslam_tpu_torch.eval import batch
from phdslam_tpu_torch.runtime import io as tio
from phdslam_tpu_torch.runtime import profiling
from phdslam_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                  profile_single_update,
                                                  save_checkpoint)
from phdslam_tpu_torch.slam import SynthSLAMRunner
from phdslam_tpu_torch.types import init_state, state_to_numpy

from test_torch_step import jax_state_arrays, replay_noise

SEED = 3
# the JAX package's CLI test configuration (tests/test_runtime.py), with the
# weighting the port takes (scheme 1 is not ported on the static map)
CFG_TEXT = ("motion_type = 1\nn_particles = 8\nmax_features = 16\n"
            "max_measurements = 16\nl = 2.83\nh = 0.76\na = 3.78\n"
            "b = 0.5\nstd_encoder = 2\nstd_alpha = 0.0873\n"
            "max_range = 10\nstd_range = 1\nstd_bearing = 0.0349\n"
            "clutter_rate = 20\npd = 0.95\nparticle_weighting = 0\n"
            "filter_type = 0\n")


@pytest.fixture(scope="module")
def batch_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("batch"))
    batch.generate_batch_datasets(root, n_runs=1, n_landmarks=15, n_steps=30,
                                  seed=SEED)
    return root


def write_cfg(path, data_dir, extra=""):
    with open(path, "w") as fh:
        fh.write(CFG_TEXT + extra + f"data_directory = {data_dir}\n")
    return str(path)


def cli(argv):
    return main(argv, device="cpu")


def logs(out_dir):
    return sorted(f for f in os.listdir(out_dir)
                  if f.startswith("state_estimate"))


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


def assert_logs_equal(a, b, names):
    for name in names:
        assert read(os.path.join(a, name)) == read(os.path.join(b, name)), \
            name


def test_runtime_imports_no_jax_and_no_matplotlib():
    code = ("import sys\n"
            "import phdslam_tpu_torch.__main__, phdslam_tpu_torch.eval.batch\n"
            "import phdslam_tpu_torch.runtime.checkpoint\n"
            "import phdslam_tpu_torch.runtime.profiling\n"
            "import phdslam_tpu_torch.parallel, phdslam_tpu_torch.parallel.sim\n"
            "import phdslam_tpu_torch.parallel.migrate\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'phdslam_tpu', 'matplotlib'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ----------------------------------------------------------------------------
# state logs and particle dumps
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["phd", "cphd", "dynamic", "empty map"])
def test_write_state_log_matches_jax(tmp_path, monkeypatch, case):
    """Byte-equal to the JAX package's pure-Python writer on the same
    arrays (append mode included: each step written twice), and parsed
    equal to what its native writer writes, where that is built."""
    rng = np.random.default_rng(SEED)
    P, K, C = 7, 12, 9
    w = np.where(rng.uniform(size=K) < 0.5, rng.uniform(0, 1.5, K), 0.0)
    if case == "empty map":
        w[:] = 0.0
    gm = (w.astype(np.float32), rng.normal(0, 9, (K, 4)).astype(np.float32),
          rng.uniform(0.01, 3, (K, 4, 4)).astype(np.float32))
    static, dyn = (None, gm) if case == "dynamic" else (gm, None)
    args = (rng.normal(0, 5, 6).astype(np.float32), static, dyn,
            rng.normal(-2, 1, P).astype(np.float32),
            rng.normal(0, 5, (P, 6)).astype(np.float32),
            rng.integers(0, P, P).astype(np.int32),
            rng.normal(-3, 1, C + 1).astype(np.float32), C,
            1 if case == "cphd" else 0)
    dirs = {k: tmp_path / k for k in ("port", "python", "native")}
    for d in dirs.values():
        d.mkdir()
    native = jio._native_textio
    for t in (0, 5, 5):
        tio.write_state_log(str(dirs["port"]), t, *args)
        if native is not None:
            jio.write_state_log(str(dirs["native"]), t, *args)
        monkeypatch.setattr(jio, "_native_textio", None)
        jio.write_state_log(str(dirs["python"]), t, *args)
        monkeypatch.setattr(jio, "_native_textio", native)
    names = sorted(os.listdir(dirs["port"]))
    assert names == ["state_estimate00000.log", "state_estimate00005.log"]
    assert_logs_equal(dirs["port"], dirs["python"], names)
    if native is not None:
        for name in names:
            got = batch.parse_state_log(str(dirs["port"] / name))
            want = batch.parse_state_log(str(dirs["native"] / name))
            for k in got:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)


@pytest.mark.parametrize("filter_type", [0, 1])
def test_write_particles_mat_matches_jax(tmp_path, filter_type):
    """The same keys, shapes and values as the JAX writer for a JAX state
    carried across with types.state_from_jax (the port's state has no
    dynamic map: the empty one JAX holds is written in its place)."""
    from phdslam_tpu.config import SlamConfig as JaxConfig
    from phdslam_tpu.types import init_state as jax_init_state
    from phdslam_tpu_torch.types import state_from_jax
    rng = np.random.default_rng(SEED)
    jcfg = JaxConfig(n_particles=6, max_features=10,
                     filter_type=filter_type, max_cardinality=12)
    js = jax_init_state(jcfg)
    P, K = 6, 10
    js = js.replace(pose=rng.normal(0, 3, (P, 6)).astype(np.float32),
                    log_weight=rng.normal(-2, 1, P).astype(np.float32),
                    variance=rng.normal(0, 1, P).astype(np.float32))
    js = js.replace(map_static=js.map_static.replace(
        weight=rng.uniform(0, 1, (P, K)).astype(np.float32),
        mean=rng.normal(0, 5, (P, K, 2)).astype(np.float32)))
    ts = state_from_jax(jax_state_arrays(js))
    est = tuple(rng.normal(0, 1, s).astype(np.float32)
                for s in ((K,), (K, 2), (K, 2, 2)))
    jio.write_particles_mat(str(tmp_path / "jax.mat"), js, jcfg,
                            map_estimate=est)
    tio.write_particles_mat(str(tmp_path / "port.mat"), ts, jcfg,
                            map_estimate=est)
    got = sio.loadmat(str(tmp_path / "port.mat"))
    want = sio.loadmat(str(tmp_path / "jax.mat"))
    keys = sorted(k for k in want if not k.startswith("__"))
    assert sorted(k for k in got if not k.startswith("__")) == keys
    assert ("cardinalities" in keys) == (filter_type == 1)
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_trajectory_matches_jax(tmp_path):
    rng = np.random.default_rng(SEED)
    path = tmp_path / "traj.txt"
    with open(path, "w") as fh:
        fh.write("% x y th vx vy vth\n\n")
        for row in rng.normal(0, 4, (9, 7)):
            fh.write(" ".join("%.6f" % v for v in row) + "\n")
        fh.write("1 2 3\n")
    np.testing.assert_array_equal(tio.load_trajectory(str(path)),
                                  jio.load_trajectory(str(path)))


# ----------------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------------

def small_runner(data_dir, **over):
    cfg = load_config("cfg/ackerman.cfg", dict(
        n_particles=8, max_features=32, max_measurements=16,
        detection_topk=8, merge_candidate_cap=64, particle_weighting=0,
        **over))
    return SynthSLAMRunner(cfg, data_dir, device="cpu")


def test_checkpoint_round_trip(tmp_path, batch_root):
    r = small_runner(batch_root + "/run000", filter_type=1)
    r.run(chunk=3, collect_maps=False)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, r.state, extra={"step": 7, "note": "x",
                                          "v": torch.arange(3)})
    like = init_state(r.cfg)
    back, extra = load_checkpoint(path, like, extra_like={})
    got, want = state_to_numpy(back), state_to_numpy(r.state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert back.step == r.state.step and back.map_dynamic is None
    assert extra["step"] == 7 and extra["note"] == "x"
    assert torch.equal(extra["v"], torch.arange(3))
    assert load_checkpoint(path, like).step == r.state.step


def test_checkpoint_mismatch_raises(tmp_path):
    cfg = load_config("cfg/ackerman.cfg", {"n_particles": 8})
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, init_state(cfg))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, init_state(cfg, n_particles=16))
    cphd = load_config("cfg/ackerman.cfg", {"n_particles": 8,
                                            "filter_type": 1})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(path, init_state(cphd))
    load_checkpoint(path, init_state(cfg))      # the matching config loads


def test_restore_refuses_another_generator_kind(tmp_path, batch_root):
    """A checkpoint's generator state is kept for the device type that
    drew it: restoring it on another fails, never reseeds."""
    r = small_runner(batch_root + "/run000")
    r.run(chunk=4, collect_maps=False)
    path = str(tmp_path / "ckpt")
    r.save(path, 4)
    payload = torch.load(os.path.join(path, "checkpoint.pt"),
                         weights_only=True)
    payload["extra"]["generator_device"] = "cuda"
    torch.save(payload, os.path.join(path, "checkpoint.pt"))
    with pytest.raises(ValueError, match="generator"):
        small_runner(batch_root + "/run000").restore(path)


def test_profile_single_update(tmp_path):
    cfg = load_config("cfg/ackerman.cfg", {"n_particles": 8,
                                           "particle_weighting": 0})
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, init_state(cfg))
    res = profile_single_update(cfg, path, device="cpu")
    assert np.isfinite(res["est_poses"]).all()
    assert res["est_poses"].shape == (1, 6) and res["update_ms"] > 0


# ----------------------------------------------------------------------------
# the command line
# ----------------------------------------------------------------------------

def test_cli_synth(batch_root, tmp_path):
    cfg = write_cfg(tmp_path / "t.cfg", f"{batch_root}/run000")
    out = str(tmp_path / "out")
    assert cli([cfg, "synth", "--out-dir", out, "--steps", "12",
                "--runner", "chunked", "--chunk", "5"]) == 0
    assert len(logs(out)) == 12
    assert os.path.exists(os.path.join(out, "config.cfg"))
    # chunk-granular times: one value per chunk of 5, 5 and 2 steps
    times = np.loadtxt(os.path.join(out, "loopTime.log"))
    assert len(times) == 12
    assert len(np.unique(times[:5])) == len(np.unique(times[5:10])) == 1
    assert len(np.unique(times)) > 1, "loopTime.log is a repeated average"
    with open(os.path.join(out, logs(out)[0])) as fh:
        assert len(fh.read().splitlines()) == 7
    gt = np.load(f"{batch_root}/groundtruth.npz")
    r = batch.analyze_log_dir(out, gt["traj"], gt["landmarks"])
    assert r["mean_pose_err"] < 3.0


def timestamped_data(tmp_path):
    """tests/test_runtime.py's fixture: measurements at .25, .75, ...,
    controls at .5, 1.0, ...: alternating measurement-only and
    control-only steps, so a checkpoint at step 8 sits between a control
    step and a measurement-only step that reuses its control."""
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(3)
    n = 10
    with open(data / "measurements.txt", "w") as fh:
        fh.write("% header\n")
        for _ in range(n):
            r = rng.uniform(1, 8, 3)
            b = rng.uniform(-1, 1, 3)
            fh.write(" ".join(f"{x:.4f} {y:.4f}" for x, y in zip(r, b))
                     + " \n")
    with open(data / "controls.txt", "w") as fh:
        fh.write("% header\n")
        for _ in range(n):
            fh.write("1.5 0.05\n")
    with open(data / "measurement_times.txt", "w") as fh:
        fh.write("\n".join(f"{0.25 + 0.5 * i:.2f}" for i in range(n)) + "\n")
    with open(data / "control_times.txt", "w") as fh:
        fh.write("\n".join(f"{0.5 + 0.5 * i:.2f}" for i in range(n)) + "\n")
    return str(data)


@pytest.mark.parametrize("extra", ["", "compute_variance = 1\n"])
def test_cli_resume_is_bit_equal(tmp_path, extra):
    """--checkpoint-every saves inside the loop; --resume continues from
    the saved state and generators, and every log after the checkpoint is
    byte-equal to the uninterrupted run's (with compute_variance the
    second generator is carried too)."""
    cfg = write_cfg(tmp_path / "t.cfg", timestamped_data(tmp_path),
                    "max_features = 16\n" + extra)
    base = ["--steps", "16", "--runner", "chunked", "--chunk", "4"]
    full, ck, res = (str(tmp_path / d) for d in ("full", "ck", "resumed"))
    assert cli([cfg, "synth", "--out-dir", full] + base) == 0
    assert cli([cfg, "synth", "--out-dir", ck] + base
               + ["--checkpoint-every", "8"]) == 0
    assert sorted(os.listdir(os.path.join(ck, "checkpoints"))) == [
        "step00008", "step00016"]
    assert cli([cfg, "synth", "--out-dir", res] + base + [
        "--resume", os.path.join(ck, "checkpoints", "step00008")]) == 0
    assert logs(res) == logs(full)[8:]
    assert_logs_equal(full, ck, logs(full))
    assert_logs_equal(full, res, logs(res))
    times = np.loadtxt(os.path.join(res, "loopTime.log"))
    assert len(times) == 16 and (times[:8] == 0).all()
    # the whole final state too (the variance, which no log holds, included)
    tcfg = load_config(cfg, {"n_steps": 16})
    whole = SynthSLAMRunner(tcfg, device="cpu")
    whole.run(chunk=4)
    resumed = SynthSLAMRunner(tcfg, device="cpu")
    assert resumed.restore(os.path.join(ck, "checkpoints", "step00008")) == 8
    resumed.run(chunk=4, start_step=8)
    got, want = state_to_numpy(resumed.state), state_to_numpy(whole.state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (want["variance"] != 0).any() == bool(extra)

    # --resume with a runner the JAX version cannot resume is refused
    with pytest.raises(SystemExit):
        cli([cfg, "synth", "--out-dir", str(tmp_path / "x"), "--steps", "16",
             "--runner", "scanned", "--resume",
             os.path.join(ck, "checkpoints", "step00008")])
    # a start at or past the end, or off a chunk boundary, raises
    r = SynthSLAMRunner(load_config(cfg, {"n_steps": 16}), device="cpu")
    with pytest.raises(ValueError, match="past the end"):
        r.run(chunk=4, start_step=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        r.run(chunk=4, start_step=6)


def test_cli_timing_logs(batch_root, tmp_path):
    """--timing: per-step loopTime.log and predicttime.log, and the timed
    prediction draws nothing: every log equals the untimed run's."""
    cfg = write_cfg(tmp_path / "t.cfg", f"{batch_root}/run000",
                    "n_predict_particles = 2\n")
    timed, plain = str(tmp_path / "timed"), str(tmp_path / "plain")
    assert cli([cfg, "synth", "--out-dir", timed, "--steps", "8",
                "--timing"]) == 0
    assert cli([cfg, "synth", "--out-dir", plain, "--steps", "8"]) == 0
    lt = np.loadtxt(os.path.join(timed, "loopTime.log"))
    pt = np.loadtxt(os.path.join(timed, "predicttime.log"))
    assert len(lt) == 8 and len(pt) == 8
    assert len(np.unique(lt)) > 1
    assert pt[0] == 0 and (pt[1:] > 0).all()   # step 0 does not predict
    assert logs(timed) == logs(plain)
    assert_logs_equal(timed, plain, logs(plain))


def test_cli_replay_artifact(batch_root, tmp_path):
    """--replay gif on the CPHD filter: the animated 4-panel replay and the
    weight inspector."""
    cfg = write_cfg(tmp_path / "t.cfg", f"{batch_root}/run000",
                    "max_cardinality = 24\nfilter_type = 1\n")
    out = str(tmp_path / "rep")
    assert cli([cfg, "synth", "--out-dir", out, "--steps", "10",
                "--runner", "chunked", "--chunk", "5",
                "--replay", "gif", "--replay-every", "4"]) == 0
    gif = os.path.join(out, "replay", "replay.gif")
    assert os.path.exists(gif) and os.path.getsize(gif) > 1000
    wi = os.path.join(out, "weights.png")
    assert os.path.exists(wi) and os.path.getsize(wi) > 1000


def test_cli_profile(batch_root, tmp_path, capsys):
    cfg = write_cfg(tmp_path / "t.cfg", f"{batch_root}/run000")
    ck = str(tmp_path / "ck")
    assert cli([cfg, "synth", "--out-dir", ck, "--steps", "8", "--chunk",
                "4", "--checkpoint-every", "4"]) == 0
    assert cli([cfg, "--out-dir", str(tmp_path / "p"), "--profile",
                os.path.join(ck, "checkpoints", "step00004")]) == 0
    assert "done: 1 steps" in capsys.readouterr().out


def test_cli_disparity(tmp_path):
    from phdslam_tpu_torch.eval.simdata import (generate_disparity_world,
                                                write_disparity_run_dir)
    _, _, meas = generate_disparity_world(n_landmarks=10, n_steps=12, seed=2)
    ddir = str(tmp_path / "disp")
    write_disparity_run_dir(ddir, meas)
    cfg_path = str(tmp_path / "d.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("n_particles = 8\nmax_features = 12\nmax_measurements = 16\n"
                 "particles_per_feature = 16\nfx = 500\nfy = 500\n"
                 "u0 = 320\nv0 = 240\nimage_width = 640\nimage_height = 480\n"
                 "std_u = 1\nstd_v = 1\ndisparity_birth = 150\n"
                 "std_d_birth = 100\nclutter_rate = 2\npd = 0.95\n"
                 "birth_weight = 0.05\nmin_separation = 20\n"
                 "particle_weighting = 0\ndt = 0.5\ninitial_vx = 0.1\n"
                 f"data_directory = {ddir}\n")
    out = str(tmp_path / "out")
    assert cli([cfg_path, "disparity", "--out-dir", out, "--chunk", "5"]) == 0
    est = np.loadtxt(out + "/trajectory.txt")
    assert est.shape == (12, 12) and np.isfinite(est).all()
    times = np.loadtxt(out + "/loopTime.log")
    assert len(times) == 12 and len(np.unique(times)) == 3


def test_cli_distributed_single_process(batch_root, tmp_path, monkeypatch):
    """--distributed with no launcher environment runs the one-process
    path, as the JAX CLI does: the same logs as without the flag."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    cfg = write_cfg(tmp_path / "t.cfg", f"{batch_root}/run000",
                    "n_steps = 8\n")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli([cfg, "--out-dir", a]) == 0
    assert cli([cfg, "--out-dir", b, "--distributed"]) == 0
    assert logs(a) == logs(b) and len(logs(a)) == 8
    assert_logs_equal(a, b, logs(a))


# ----------------------------------------------------------------------------
# the NaN policy
# ----------------------------------------------------------------------------

def poison_step(monkeypatch, k):
    """Step k of every SynthSLAMRunner starts from NaN log weights."""
    step = SynthSLAMRunner.step

    def poisoned(self, n, noise=None):
        if n == k:
            self.state = self.state.replace(
                log_weight=self.state.log_weight * float("nan"))
        return step(self, n, noise)
    monkeypatch.setattr(SynthSLAMRunner, "step", poisoned)


def test_nan_policy(batch_root, tmp_path, monkeypatch, capsys):
    """Without debug: the message, a result, nan_step = k. With debug (the
    argument, debug_mode or --debug): FloatingPointError at step k."""
    k = 5
    poison_step(monkeypatch, k)
    res = small_runner(batch_root + "/run000", n_steps=10).run(chunk=4)
    assert capsys.readouterr().out == f"nan weights detected at step {k}!\n"
    assert res["nan_step"] == k
    assert np.isfinite(res["n_eff"][:k]).all() and np.isnan(res["n_eff"][k])
    assert res["est_poses"].shape == (10, 6)
    with pytest.raises(FloatingPointError, match=f"step {k}"):
        small_runner(batch_root + "/run000", n_steps=10).run(debug=True)
    with profiling.debug_mode(), pytest.raises(FloatingPointError):
        small_runner(batch_root + "/run000", n_steps=10).run()
    assert not profiling.nan_checks()
    cfg = write_cfg(tmp_path / "t.cfg", f"{batch_root}/run000")
    with pytest.raises(FloatingPointError):
        cli([cfg, "--out-dir", str(tmp_path / "o"), "--steps", "8",
             "--debug"])
    clean = small_runner(batch_root + "/run000", n_steps=4).run(chunk=4)
    assert clean["nan_step"] is None


def test_disparity_nan_policy(tmp_path, monkeypatch, capsys):
    """run_disparity reports the first NaN step and returns (raises under
    debug_mode), as the synth runner does."""
    from phdslam_tpu_torch import SlamConfig
    from phdslam_tpu_torch.eval.simdata import (generate_disparity_world,
                                                write_disparity_run_dir)
    from phdslam_tpu_torch.slam_disparity import (DisparityRunner,
                                                  run_disparity)
    _, _, meas = generate_disparity_world(n_landmarks=8, n_steps=8, seed=2)
    write_disparity_run_dir(str(tmp_path), meas)
    cfg = SlamConfig(n_particles=6, max_features=10, max_measurements=16,
                     particles_per_feature=8, particle_weighting=0, dt=0.5,
                     min_separation=20.0, disparity_birth=150.0,
                     std_d_birth=100.0, clutter_rate=2.0)
    k = 3
    step = DisparityRunner.step

    def poisoned(self, n, noise=None):
        if n == k:
            self.state = self.state.replace(
                log_weight=self.state.log_weight * float("nan"))
        return step(self, n, noise)
    monkeypatch.setattr(DisparityRunner, "step", poisoned)
    res = run_disparity(cfg, data_dir=str(tmp_path), chunk=4, device="cpu")
    assert capsys.readouterr().out == f"nan weights detected at step {k}!\n"
    assert res["nan_step"] == k and len(res["chunk_ms"]) == 2
    with profiling.debug_mode(), pytest.raises(FloatingPointError):
        run_disparity(cfg, data_dir=str(tmp_path), device="cpu")


def test_nan_policy_matches_jax(batch_root, capsys):
    """Both runners print the same line for NaN weights from the first step
    and return their results."""
    from phdslam_tpu.config import SlamConfig as JaxConfig
    from phdslam_tpu.slam import SynthSLAMRunner as JaxRunner
    over = dict(n_particles=8, max_features=16, max_measurements=16,
                motion_type=1, particle_weighting=0, pallas_detect=0,
                pallas_merge=0, n_steps=3)
    jr = JaxRunner(JaxConfig(**over), batch_root + "/run000")
    jr.state = jr.state.replace(log_weight=jr.state.log_weight * np.nan)
    jres = jr.run()
    want = capsys.readouterr().out
    tr = SynthSLAMRunner(load_config("cfg/ackerman.cfg", over),
                         batch_root + "/run000", device="cpu")
    tr.state = tr.state.replace(log_weight=tr.state.log_weight * np.nan)
    tres = tr.run()
    assert capsys.readouterr().out == want == \
        "nan weights detected at step 0!\n"
    assert np.isnan(jres["n_eff"]).all() and np.isnan(tres["n_eff"]).all()


# ----------------------------------------------------------------------------
# timing and tracing
# ----------------------------------------------------------------------------

def test_step_timer_and_trace(tmp_path, batch_root):
    out, ms = profiling.timed_call(torch.ones, 3)
    assert ms > 0 and torch.equal(out, torch.ones(3))
    r = small_runner(batch_root + "/run000", n_steps=2)
    with profiling.trace(str(tmp_path / "tr")):
        r.run()
    with open(tmp_path / "tr" / "trace.json") as fh:
        text = fh.read()
    assert '"phd.extract_resample"' in text and '"runner.step"' in text
    with open(tmp_path / "tr" / "spans.json") as fh:
        spans = json.load(fh)
    assert spans["spans"]["runner.step"]["count"] == 2
    assert spans["spans"]["phd.extract_resample"]["parents"] == {
        "runner.step": 2}
    assert set(spans["counters"]) == {"launches", "syncs", "gc"}


# ----------------------------------------------------------------------------
# the slice as a whole against the JAX package
# ----------------------------------------------------------------------------

def test_cli_matches_jax_cli(batch_root, tmp_path, monkeypatch):
    """JAX's CLI (chunked runner, chunk 4, 12 steps) and the port's on the
    batch fixture's run000 at P=8, the port on JAX's draws: every state
    log parses equal (rtol 1e-4 / atol 1e-5; the ancestors exactly)."""
    from phdslam_tpu.__main__ import main as jax_main
    from phdslam_tpu.config import load_config as jax_load_config
    cfg = write_cfg(tmp_path / "t.cfg", f"{batch_root}/run000",
                    "max_features = 32\ndetection_topk = 8\n"
                    "merge_candidate_cap = 64\npallas_detect = 2\n"
                    "pallas_merge = 2\nresample_threshold = 0.9\n")
    jcfg = jax_load_config(cfg)
    key = jax.random.PRNGKey(jcfg.seed)

    def jax_draws(self):
        like = types.SimpleNamespace(pose=self.state.pose, rng=key,
                                     step=self.state.step)
        return replay_noise(like, jcfg)
    monkeypatch.setattr(SynthSLAMRunner, "noise", jax_draws)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["synth", "--steps", "12", "--runner", "chunked", "--chunk", "4"]
    assert jax_main([cfg] + argv + ["--out-dir", jdir]) == 0
    assert cli([cfg] + argv + ["--out-dir", tdir]) == 0
    assert logs(tdir) == logs(jdir) and len(logs(jdir)) == 12
    resampled = 0
    for name in logs(jdir):
        with open(os.path.join(jdir, name)) as fh:
            want = fh.read().splitlines()
        with open(os.path.join(tdir, name)) as fh:
            got = fh.read().splitlines()
        assert len(got) == len(want) == 7, name
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = np.fromstring(g, sep=" "), np.fromstring(w, sep=" ")
            assert g.shape == w.shape, (name, i)
            if i == 5:
                np.testing.assert_array_equal(g, w, err_msg=name)
                resampled += not np.array_equal(w, np.arange(len(w)))
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} line {i}")
    assert resampled > 0          # the run resampled, and alike
