"""Host-side modules of the port against the JAX package on the same inputs:
math, motion and measurement models, the EKF pre-update and candidate
tables, the selection sorts, resampling, the config parser and the
dataset loaders — plus the check that the port never imports jax."""

import dataclasses
import glob
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phdslam_tpu.config as jcfg_mod
import phdslam_tpu.runtime.io as jio
from phdslam_tpu.models import measurement as jmeas
from phdslam_tpu.models import vehicle as jveh
from phdslam_tpu.ops import ekf as jekf
from phdslam_tpu.ops import gm_merge as jgm
from phdslam_tpu.ops import math as jmath
from phdslam_tpu.ops import resample as jres
from phdslam_tpu_torch import config as tcfg_mod
from phdslam_tpu_torch.models import measurement as tmeas
from phdslam_tpu_torch.models import vehicle as tveh
from phdslam_tpu_torch.ops import ekf as tekf
from phdslam_tpu_torch.ops import gm_merge as tgm
from phdslam_tpu_torch.ops import math as tmath
from phdslam_tpu_torch.ops import resample as tres
from phdslam_tpu_torch.runtime import io as tio

CFG = tcfg_mod.load_config("cfg/ackerman.cfg")


def close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def scene(seed=0, P=3, K=16, M=6):
    """Poses, a map with empty slots, and measurements (numpy)."""
    rng = np.random.default_rng(seed)
    pose = np.zeros((P, 6), np.float32)
    pose[:, :2] = rng.normal(0, 0.5, (P, 2))
    pose[:, 2] = rng.uniform(-np.pi, np.pi, P)
    mean = rng.uniform(-12, 12, (P, K, 2)).astype(np.float32)
    A = rng.normal(0, 0.4, (P, K, 2, 2))
    cov = (A @ A.transpose(0, 1, 3, 2) + 0.1 * np.eye(2)).astype(np.float32)
    w = np.where(rng.uniform(size=(P, K)) < 0.7,
                 rng.uniform(0.05, 1.0, (P, K)), 0.0).astype(np.float32)
    mean[w == 0] = 0.0
    cov[w == 0] = np.eye(2, dtype=np.float32)
    z = np.column_stack([rng.uniform(-1, 10, M),
                         rng.uniform(-np.pi, np.pi, M)]).astype(np.float32)
    return pose, mean, cov, w, z


# ----------------------------------------------------------------------------
# ops/math.py
# ----------------------------------------------------------------------------

def test_wrap_angle_matches_jax_exactly():
    pi32 = np.float32(np.pi)
    a = np.concatenate([
        np.array([np.pi, -np.pi, pi32, -pi32, np.nextafter(pi32, 4),
                  -np.nextafter(pi32, 4), 3 * np.pi, -3 * np.pi, 2 * np.pi,
                  -2 * np.pi, 0.0, -0.0, 1e-8, -1e-8, 100.0, -100.0]),
        np.random.default_rng(0).uniform(-20, 20, 200)]).astype(np.float32)
    got = tmath.wrap_angle(torch.from_numpy(a)).numpy()
    want = np.asarray(jmath.wrap_angle(jnp.asarray(a)))
    np.testing.assert_array_equal(got, want)
    # a remainder-based wrap rounds differently: -1e-8 wraps to 0 here
    assert got[13] == 0.0


def test_small_math_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 5, 50).astype(np.float32)
    # log differs by an ulp between the two libraries' implementations
    close(tmath.safe_log(torch.from_numpy(x)),
          jmath.safe_log(jnp.asarray(x)), rtol=2e-7, atol=0)
    lw = rng.normal(0, 3, 40).astype(np.float32)
    close(tmath.logsumexp(torch.from_numpy(lw), dim=0),
          jmath.logsumexp(jnp.asarray(lw), axis=0))
    A = rng.normal(0, 1, (10, 2, 2)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1) + np.eye(2, dtype=np.float32)
    for fn in ("det2", "inv2", "sym"):
        close(getattr(tmath, fn)(torch.from_numpy(S)),
              getattr(jmath, fn)(jnp.asarray(S)), rtol=1e-5)
    m = rng.normal(0, 3, (10, 2)).astype(np.float32)
    close(tmath.mahalanobis2(torch.from_numpy(m[:1]), torch.from_numpy(S[:1]),
                             torch.from_numpy(m), torch.from_numpy(S)),
          jmath.mahalanobis2(jnp.asarray(m[:1]), jnp.asarray(S[:1]),
                             jnp.asarray(m), jnp.asarray(S)), rtol=1e-5)


# ----------------------------------------------------------------------------
# models
# ----------------------------------------------------------------------------

def test_ackerman_predict_with_given_eps():
    pose, *_ = scene(2, P=64)
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, (64, 2), dtype=jnp.float32))
    control = np.array([2.5, 0.05], np.float32)
    geom = (CFG.l, CFG.h, CFG.a, CFG.b)
    std = (CFG.std_encoder, CFG.std_alpha)
    want = jveh.ackerman_predict(jnp.asarray(pose), jnp.asarray(control),
                                 geom, std, jnp.float32(1.0), key)
    got = tveh.ackerman_predict(torch.from_numpy(pose),
                                tuple(float(c) for c in control), geom, std,
                                1.0, torch.from_numpy(eps))
    close(got, want, rtol=1e-5, atol=1e-5)


def test_measurement_model_matches_jax():
    pose, mean, cov, w, z = scene(3)
    pb = pose[:, None, :]
    tr = tmeas.predict_measurement(torch.from_numpy(pb),
                                   torch.from_numpy(mean))
    jr = jmeas.predict_measurement(jnp.asarray(pb), jnp.asarray(mean))
    for g, j in zip(tr, jr):
        close(g, j, rtol=1e-5, atol=1e-5)
    close(tmeas.detection_probability(tr[0], tr[1], CFG),
          jmeas.detection_probability(jr[0], jr[1], CFG))
    np.testing.assert_array_equal(
        tmeas.classify_in_range(torch.from_numpy(pb), torch.from_numpy(mean),
                                torch.from_numpy(w), CFG).numpy(),
        np.asarray(jmeas.classify_in_range(jnp.asarray(pb), jnp.asarray(mean),
                                           jnp.asarray(w), CFG)))
    close(tmeas.measurement_jacobian(*(tr[i] for i in (2, 3, 0, 4))),
          jmeas.measurement_jacobian(*(jr[i] for i in (2, 3, 0, 4))),
          rtol=1e-5, atol=1e-6)
    for g, j in zip(tmeas.birth_mean_cov(torch.from_numpy(pb),
                                         torch.from_numpy(z), CFG),
                    jmeas.birth_mean_cov(jnp.asarray(pb), jnp.asarray(z),
                                         CFG)):
        close(g, j, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# ops/ekf.py
# ----------------------------------------------------------------------------

def test_ekf_preupdate_matches_jax():
    pose, mean, cov, w, z = scene(4)
    t = tekf.ekf_preupdate(torch.from_numpy(pose[:, None, :]),
                           torch.from_numpy(mean), torch.from_numpy(cov), CFG)
    j = jekf.ekf_preupdate(jnp.asarray(pose[:, None, :]), jnp.asarray(mean),
                           jnp.asarray(cov), CFG)
    for name in tekf.PreUpdate._fields:
        close(getattr(t, name), getattr(j, name), rtol=2e-5, atol=1e-6)
    # per particle, the linear detection grid
    pdw_t = tekf.ekf_detection_linear(
        tekf.PreUpdate(*(x[0] for x in t)), torch.from_numpy(w[0]),
        torch.from_numpy(z))
    pdw_j = jekf.ekf_detection_linear(
        jax.tree.map(lambda x: x[0], j), jnp.asarray(w[0]), jnp.asarray(z))
    close(pdw_t, pdw_j, rtol=1e-5, atol=1e-12)


def test_candidate_tables_and_combine_match_jax():
    pose, mean, cov, w, z = scene(5, P=3, K=16, M=6)
    P, K, M, cap = 3, 16, 6, 40
    pb = pose[:, None, :]
    rng = np.random.default_rng(5)
    flat = rng.integers(0, K + M * K + M, (P, cap))
    sel = rng.random((P, cap)) < 0.8

    t_pre = tekf.ekf_preupdate(torch.from_numpy(pb), torch.from_numpy(mean),
                               torch.from_numpy(cov), CFG)
    j_pre = jekf.ekf_preupdate(jnp.asarray(pb), jnp.asarray(mean),
                               jnp.asarray(cov), CFG)
    t_bm, t_bc = tmeas.birth_mean_cov(torch.from_numpy(pb),
                                      torch.from_numpy(z), CFG)
    j_bm, j_bc = jmeas.birth_mean_cov(jnp.asarray(pb), jnp.asarray(z), CFG)
    t_k, t_m = tekf.candidate_tables_T(torch.from_numpy(mean),
                                       torch.from_numpy(cov), t_pre,
                                       torch.from_numpy(z), t_bm, t_bc)
    j_tabs = [jekf.candidate_tables_T(
        jnp.asarray(mean[p]), jnp.asarray(cov[p]),
        jax.tree.map(lambda x: x[p], j_pre), jnp.asarray(z), j_bm[p],
        j_bc[p]) for p in range(P)]
    assert t_k.shape == (P, 16, K) and t_m.shape == (P, 8, M)
    close(t_k, np.stack([np.asarray(a) for a, _ in j_tabs]), rtol=2e-5,
          atol=1e-6)
    close(t_m, np.stack([np.asarray(b) for _, b in j_tabs]), rtol=1e-5,
          atol=1e-5)

    t_ix = tekf.candidate_gather_indices(torch.from_numpy(flat), K, M, True)
    j_ix = jekf.candidate_gather_indices(jnp.asarray(flat), K, M, True)
    for g, j in zip(t_ix, j_ix):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    k_eff, m_eff, is_p, is_d = (np.asarray(x) for x in j_ix)
    r_k = np.take_along_axis(t_k.numpy(), k_eff[:, None, :], axis=2)
    r_m = np.take_along_axis(t_m.numpy(), m_eff[:, None, :], axis=2)
    tm, tc = tekf.combine_selected_planes(
        torch.from_numpy(r_k), torch.from_numpy(r_m), torch.from_numpy(is_p),
        torch.from_numpy(is_d), torch.from_numpy(sel), 2, True)
    jm, jc = jekf.combine_selected_planes(
        jnp.asarray(r_k), jnp.asarray(r_m), jnp.asarray(is_p),
        jnp.asarray(is_d), jnp.asarray(sel), 2, True)
    for g, j in zip(tm + tc, jm + jc):
        close(g, j, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# ops/gm_merge.py selection sorts and ops/resample.py
# ----------------------------------------------------------------------------

def test_select_live_topT_with_ties_matches_jax():
    rng = np.random.default_rng(6)
    grid = rng.choice([0.0, 0.2, 0.5, 0.5, 0.9], size=(3, 5, 24))
    grid = grid.astype(np.float32)
    thr = np.full((3, 5), 0.1, np.float32)
    tv, ti, tn, tk = tgm.select_live_topT(torch.from_numpy(grid),
                                          torch.from_numpy(thr), 6)
    for p in range(3):
        jv, ji, jn, jk = jgm.select_live_topT(jnp.asarray(grid[p]),
                                              jnp.asarray(thr[p]), 6)
        np.testing.assert_array_equal(tv[p].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti[p].numpy(), np.asarray(ji))
        assert int(tn[p]) == int(jn) and int(tk[p]) == int(jk)


def test_topcap_sort_with_ties_matches_jax():
    rng = np.random.default_rng(7)
    red_w = rng.choice([0.0, 0.1, 0.3, 0.3, 0.7], size=(4, 60))
    red_w = red_w.astype(np.float32)
    red_act = rng.random((4, 60)) < 0.8
    red_flat = rng.permutation(200)[:60].astype(np.int64)
    flat = np.broadcast_to(red_flat, (4, 60)).copy()
    got = tgm.topcap_sort(torch.from_numpy(red_w), torch.from_numpy(red_act),
                          torch.from_numpy(flat), 24)
    for p in range(4):
        want = jgm.topcap_sort(jnp.asarray(red_w[p]), jnp.asarray(red_act[p]),
                               jnp.asarray(red_flat.astype(np.int32)), 24)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g[p].numpy(), np.asarray(j))


def test_resampling_matches_jax():
    rng = np.random.default_rng(8)
    lw = rng.normal(0, 2, 256).astype(np.float32)
    lw -= np.log(np.exp(lw.astype(np.float64)).sum()).astype(np.float32)
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, (256,), dtype=jnp.float32))
    np.testing.assert_array_equal(
        tres.systematic_ancestors(torch.from_numpy(lw), torch.from_numpy(u),
                                  256).numpy(),
        np.asarray(jres.systematic_ancestors(jnp.asarray(lw), key, 256)))
    close(tres.effective_sample_ratio(torch.from_numpy(lw)),
          jres.effective_sample_ratio(jnp.asarray(lw)), rtol=1e-5)
    # weights summing short of 1: the overrun strata take the argmax
    short = lw - np.float32(0.05)
    got = tres.systematic_ancestors(torch.from_numpy(short),
                                    torch.from_numpy(u), 256).numpy()
    want = np.asarray(jres.systematic_ancestors(jnp.asarray(short), key, 256))
    np.testing.assert_array_equal(got, want)
    assert (got == np.argmax(lw)).sum() > 1


@pytest.mark.parametrize("n", [1000, 1024, 3000])
def test_fixed_order_cumsum_and_resampling(n):
    """The resampling cumsum: torch.cumsum itself up to one block of 1024,
    the row-blocked scan beyond (n = 3000: two full rows and a padded one)
    within f32 rounding of the float64 cumsum and non-decreasing; the
    ancestors equal JAX's except where a stratum point lies within 1e-5 of
    a cumulative weight."""
    rng = np.random.default_rng(n)
    lw = rng.normal(0, 2, n).astype(np.float32)
    lw -= np.log(np.exp(lw.astype(np.float64)).sum()).astype(np.float32)
    w = torch.exp(torch.from_numpy(lw))
    got = tres.cumsum_fixed_order(w)
    exact = np.cumsum(w.double().numpy())
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-7)
    assert bool((got[1:] >= got[:-1]).all())
    if n <= tres.SCAN_BLOCK:
        assert torch.equal(got, torch.cumsum(w, dim=0))
    key = jax.random.PRNGKey(n)
    u = np.array(jax.random.uniform(key, (n,), dtype=jnp.float32))
    anc = tres.systematic_ancestors(torch.from_numpy(lw), torch.from_numpy(u),
                                    n).numpy()
    want = np.asarray(jres.systematic_ancestors(jnp.asarray(lw), key, n))
    for j in np.nonzero(anc != want)[0]:
        assert np.abs(exact - (j + u[j]) / n).min() < 1e-5


# ----------------------------------------------------------------------------
# config and loaders: copies held equal to the originals
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(glob.glob("cfg/*.cfg")))
def test_load_config_matches_jax(path):
    got = dataclasses.asdict(tcfg_mod.load_config(path))
    want = dataclasses.asdict(jcfg_mod.load_config(path))
    assert got == want
    t, j = tcfg_mod.load_config(path), jcfg_mod.load_config(path)
    assert t.clutter_density == j.clutter_density
    assert t.max_components == j.max_components


def test_config_fields_and_options_match_jax():
    assert ([(f.name, f.default) for f in
             dataclasses.fields(tcfg_mod.SlamConfig)]
            == [(f.name, f.default) for f in
                dataclasses.fields(jcfg_mod.SlamConfig)])
    assert tcfg_mod._OPTION_MAP == jcfg_mod._OPTION_MAP
    over = {"n_particles": 512, "detection_topk": 8}
    assert (dataclasses.asdict(tcfg_mod.load_config("cfg/dense.cfg", over))
            == dataclasses.asdict(jcfg_mod.load_config("cfg/dense.cfg",
                                                       over)))


@pytest.mark.parametrize("data", ["data/ackerman", "data/dense"])
def test_loaders_match_jax(data):
    got = tio.load_measurements(f"{data}/measurements.txt")
    want = jio.load_measurements(f"{data}/measurements.txt")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for name in ("controls.txt",):
        np.testing.assert_array_equal(tio.load_controls(f"{data}/{name}"),
                                      jio.load_controls(f"{data}/{name}"))
    for name in ("measurement_times.txt", "control_times.txt",
                 "no_such_file.txt"):
        np.testing.assert_array_equal(tio.load_timestamps(f"{data}/{name}"),
                                      jio.load_timestamps(f"{data}/{name}"))
    for m_max in (8, 48):
        for g, w in zip(tio.pad_measurements(got, m_max),
                        jio.pad_measurements(want, m_max)):
            np.testing.assert_array_equal(g, w)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import phdslam_tpu_torch, phdslam_tpu_torch.slam\n"
            "import phdslam_tpu_torch.eval.parity\n"
            "import phdslam_tpu_torch.eval.ospa\n"
            "import phdslam_tpu_torch.eval.simdata\n"
            "import phdslam_tpu_torch.filters.mixed\n"
            "import phdslam_tpu_torch.filters.cphd\n"
            "import phdslam_tpu_torch.filters.disparity\n"
            "import phdslam_tpu_torch.slam_disparity\n"
            "import phdslam_tpu_torch.models.feature_motion\n"
            "import phdslam_tpu_torch.kernels.build\n"
            "import phdslam_tpu_torch.kernels.detect\n"
            "import phdslam_tpu_torch.kernels.gather_cols\n"
            "import phdslam_tpu_torch.kernels.merge\n"
            "import phdslam_tpu_torch.kernels.gather_rows\n"
            "import phdslam_tpu_torch.eval.scenes\n"
            "import chip_smoke, gather_bench\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', "
            "'phdslam_tpu')\n"
            "             or m.startswith(('jax.', 'phdslam_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
