"""The port's Monte-Carlo batch layer against the JAX package: the Ackerman
generators (``eval/simdata.py``), ``eval/batch.py`` (datasets, the batch
run and its NaN-aware summary, the state-log parser and scorer) and
``eval/plots.py``, on the same numpy inputs."""

import filecmp
import os

import numpy as np
import pytest

from phdslam_tpu.eval import batch as jbatch
from phdslam_tpu.eval import simdata as jsim
from phdslam_tpu_torch import SlamConfig
from phdslam_tpu_torch.eval import batch, simdata

SEED = 3


def same_files(a, b):
    """Every file under a and b byte-equal (npz compared by array)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            same_files(pa, pb)
        elif name.endswith(".npz"):
            ga, gb = np.load(pa), np.load(pb)
            assert sorted(ga.files) == sorted(gb.files)
            for k in ga.files:
                np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name


@pytest.mark.parametrize("profile", ["loop", "straight"])
def test_generate_world_matches_jax(profile):
    got = simdata.generate_world(n_landmarks=20, n_steps=40, seed=SEED,
                                 control_profile=profile)
    want = jsim.generate_world(n_landmarks=20, n_steps=40, seed=SEED,
                               control_profile=profile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_ackerman_motion_matches_jax():
    rng = np.random.default_rng(SEED)
    for _ in range(20):
        pose = rng.uniform(-5, 5, 3)
        v, a = rng.uniform(-3, 3), rng.uniform(-0.3, 0.3)
        np.testing.assert_array_equal(
            simdata.ackerman_motion(pose, v, a, simdata.AckermanParams(), 0.1),
            jsim.ackerman_motion(pose, v, a, jsim.AckermanParams(), 0.1))


def test_generate_run_and_write_run_dir_match_jax(tmp_path):
    lm, traj, ctl = jsim.generate_world(n_landmarks=15, n_steps=30,
                                        seed=SEED)
    got = simdata.generate_run(lm, traj, ctl, simdata.SensorParams(),
                               simdata.AckermanParams(), seed=7)
    want = jsim.generate_run(lm, traj, ctl, jsim.SensorParams(),
                             jsim.AckermanParams(), seed=7)
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    simdata.write_run_dir(str(tmp_path / "port"), *got)
    jsim.write_run_dir(str(tmp_path / "jax"), *want)
    same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("motion", ["ackerman", "cv"])
def test_generate_batch_datasets_matches_jax(tmp_path, motion):
    kw = dict(n_runs=2, n_landmarks=15, n_steps=30, seed=SEED, motion=motion)
    got = batch.generate_batch_datasets(str(tmp_path / "port"), **kw)
    want = jbatch.generate_batch_datasets(str(tmp_path / "jax"), **kw)
    assert os.path.basename(got) == os.path.basename(want)
    same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def small_cfg(**kw):
    d = dict(n_particles=16, max_features=32, max_measurements=32,
             motion_type=1, feature_model=0, filter_type=0,
             l=2.83, h=0.76, a=3.78, b=0.5, std_encoder=2.0,
             std_alpha=0.0873, max_range=10.0, std_range=1.0,
             std_bearing=0.0349, clutter_rate=20.0, pd=0.95,
             birth_weight=0.05, min_separation=5.0, particle_weighting=0,
             resample_threshold=0.15, dt=0.1, seed=9)
    d.update(kw)
    return SlamConfig(**d)


@pytest.fixture(scope="module")
def batch_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("batch"))
    batch.generate_batch_datasets(root, n_runs=2, n_landmarks=15,
                                  n_steps=30, seed=SEED)
    return root


def test_run_batch_on_cpu(batch_root):
    """The JAX package's test_batch_run_and_analyze on the port."""
    res = batch.run_batch(small_cfg(), batch_root, ospa_every=10,
                          device="cpu")
    s = res.summary()
    assert s["n_runs"] == 2
    assert res.pose_err.shape == (2, 30) and res.ospa.shape == (2, 3)
    assert np.isfinite(s["mean_pose_err"]) and np.isfinite(s["mean_ospa"])
    assert s["mean_pose_err"] < 8.0


def test_run_batch_scores_nan_runs_as_nan(batch_root, monkeypatch, capsys):
    """A run whose weights turn NaN at step k scores NaN from k on; the
    summary's nanmeans count only the clean steps, as JAX's do."""
    from phdslam_tpu_torch.slam import SynthSLAMRunner
    k = 12
    step = SynthSLAMRunner.step

    def poisoned(self, n, noise=None):
        if n == k and "run001" in self.data_dir:
            self.state = self.state.replace(
                log_weight=self.state.log_weight * float("nan"))
        return step(self, n, noise)
    monkeypatch.setattr(SynthSLAMRunner, "step", poisoned)
    res = batch.run_batch(small_cfg(), batch_root, ospa_every=5,
                          device="cpu")
    assert f"nan weights detected at step {k}!" in capsys.readouterr().out
    assert np.isfinite(res.pose_err[0]).all()
    assert np.isfinite(res.pose_err[1, :k]).all()
    assert np.isnan(res.pose_err[1, k:]).all()
    assert np.isnan(res.ospa[1, k // 5 + (k % 5 > 0):]).all()
    s = res.summary()
    want = float(np.mean(np.concatenate([res.pose_err[0],
                                         res.pose_err[1, :k]])))
    assert s["mean_pose_err"] == pytest.approx(want, rel=1e-12)
    assert s["final_pose_err"] == res.pose_err[0, -1]


def write_logs_both(tmp_path, n, filter_type, seed):
    """n state logs of random arrays written by the port into port/ and by
    the JAX package's pure-Python writer into jax/."""
    from phdslam_tpu.runtime import io as jio
    from phdslam_tpu_torch.runtime import io as tio
    rng = np.random.default_rng(seed)
    P, K, C = 6, 10, 8
    dirs = [str(tmp_path / "port"), str(tmp_path / "jax")]
    for d in dirs:
        os.makedirs(d)
    for t in range(n):
        w = np.where(rng.uniform(size=K) < 0.6, rng.uniform(0, 1.2, K), 0.0)
        args = (t, rng.normal(0, 5, 6), (w, rng.normal(0, 5, (K, 2)),
                                         rng.uniform(0.1, 2, (K, 2, 2))),
                None, rng.normal(-2, 1, P), rng.normal(0, 5, (P, 6)),
                rng.integers(0, P, P), rng.normal(-3, 1, C + 4), C,
                filter_type)
        tio.write_state_log(dirs[0], *args)
        saved = jio._native_textio
        jio._native_textio = None
        try:
            jio.write_state_log(dirs[1], *args)
        finally:
            jio._native_textio = saved
    return dirs


@pytest.mark.parametrize("filter_type", [0, 1])
def test_parse_and_analyze_match_jax(tmp_path, filter_type):
    port, jax_dir = write_logs_both(tmp_path, 12, filter_type, SEED)
    same_files(port, jax_dir)
    for name in sorted(os.listdir(port)):
        got = batch.parse_state_log(os.path.join(port, name))
        want = jbatch.parse_state_log(os.path.join(jax_dir, name))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rng = np.random.default_rng(SEED + 1)
    traj, lm = rng.normal(0, 5, (20, 3)), rng.normal(0, 5, (9, 2))
    got = batch.analyze_log_dir(port, traj, lm, ospa_every=3)
    want = jbatch.analyze_log_dir(jax_dir, traj, lm, ospa_every=3)
    assert got.keys() == want.keys()
    for k in ("pose_err", "n_eff", "mean_pose_err"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the same optimal assignment's cost; the two solvers may sum it in
    # another order
    np.testing.assert_allclose(got["ospa"], want["ospa"], rtol=1e-12)
    assert got["mean_ospa"] == pytest.approx(want["mean_ospa"], rel=1e-12)


def test_plot_errors_writes_a_figure(tmp_path):
    from phdslam_tpu_torch.eval.plots import plot_errors
    rng = np.random.default_rng(SEED)
    res = batch.BatchResult(pose_err=rng.uniform(0, 1, (3, 20)),
                            ospa=rng.uniform(0, 5, (3, 4)),
                            n_eff=np.ones((3, 20)), steps_per_s=np.ones(3))
    path = plot_errors(res, str(tmp_path / "errors.png"), title="t")
    assert os.path.getsize(path) > 1000
