"""The port's plain twins above the narrow kernels' widths, against the JAX
package: the widths that take the staged wide-lane kernels on the card.

Each case feeds the same numpy-seeded inputs to the JAX function and to
the port's twin (a CPU tensor runs the twin): merge2d just above its
narrow kernel's 8192 lanes (N = 8448) in sorted and argmax mode with both
metrics, against the Pallas 2D kernel in interpret mode; merge4d at
N = 2304 in sorted and argmax mode, and merge3d at N = 2304, against the
Pallas 3D / 4D kernels in interpret mode; the detect twin at K = 2048,
plain and consolidating, against the Pallas detect kernel in interpret
mode; and one mixed
full-grid step at the mixed bench's widths (K = 128, M = 32: 4256 lanes a
map, the per-particle route) on JAX's replayed draws against the JAX
package's step. Counts exactly, values rtol 1e-4 / atol 1e-5 (the 3D / 4D
covariances rtol 1e-3, as the narrower twin tests hold them). The
kernels themselves run against these twins in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.eval.parity import _mixed_world as jax_mixed_world
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.ops.pallas_detect import detection_topT_batch
from phdslam_tpu.ops.pallas_merge import (gm_merge_pallas_batch_3d,
                                          gm_merge_pallas_batch_packed,
                                          gm_merge_pallas_batch_packed_4d)
from phdslam_tpu.types import init_state as jax_init_state
from merge_bench import full_grid_inputs, merge3d_inputs, merge4d_inputs
from merge_bench import merge_inputs as merge2d_inputs
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters.mixed import uses_fast_route
from phdslam_tpu_torch.filters.phd import check_supported, phd_step
from phdslam_tpu_torch.kernels import build
from phdslam_tpu_torch.kernels.detect import NARROW_FEATURES, detect
from phdslam_tpu_torch.kernels.merge import (NARROW_LANES, merge2d,
                                             merge3d, merge4d)
from phdslam_tpu_torch.ops.gm_merge import merge_out, unpack_planes
from phdslam_tpu_torch.types import state_from_jax, state_to_numpy
from test_torch_mixed import MIXED_STEP, assert_states_close, close, t
from test_torch_step import jax_state_arrays, replay_noise

CPU = torch.device("cpu")


def assert_merges_close(got, want, cov_rtol=1e-4):
    """Counts exactly; weights and means rtol 1e-4 / atol 1e-5, the
    covariances rtol ``cov_rtol`` / atol 1e-5."""
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    close(got[2], want[2], rtol=1e-4, atol=1e-5)
    close(got[0], want[0], rtol=1e-4, atol=1e-5)
    close(got[1], want[1], rtol=cov_rtol, atol=1e-5)


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("sorted_w", [True, False])
def test_merge2d_twin_above_the_narrow_width_matches_pallas(sorted_w,
                                                            metric):
    """N = 8448 > 8192: weight-sorted lanes (60% active) or the full
    grid's (10% active, in no order), Mahalanobis (min_sep 5) or Hellinger
    (0.6), into 128 slots."""
    N = NARROW_LANES[2] + 256
    planes = (merge2d_inputs(CPU, P=2, N=N, seed=1) if sorted_w
              else full_grid_inputs(CPU, P=2, N=N, seed=1))
    sep = 0.6 if metric else 5.0
    build.reset_launch_counts()
    got = merge_out(merge2d(planes, sep, 128, sorted_w, metric), 2)
    assert not build.launch_counts
    want = gm_merge_pallas_batch_packed(jnp.asarray(planes.numpy()), sep, 128,
                                        interpret=True, sorted_w=sorted_w,
                                        metric=metric)
    assert_merges_close([x.numpy() for x in got],
                        [np.asarray(x) for x in want])
    assert (got[3] > 10).all()


@pytest.mark.parametrize("sorted_w", [True, False])
def test_merge4d_twin_above_the_narrow_width_matches_pallas(sorted_w):
    """N = 2304 > 2048 4D lanes (the mixed bench's clustered dynamic map),
    weight-sorted, or in a random order for the argmax mode of the mixed
    full grid, against _merge_kernel_4d (r_par 8)."""
    N = NARROW_LANES[4] + 256
    planes = merge4d_inputs(CPU, P=2, N=N, seed=2)
    if not sorted_w:
        perm = torch.from_numpy(np.random.default_rng(2).permutation(N))
        planes = planes[:, :, perm].contiguous()
    got = merge_out(merge4d(planes, 2.0, 128, sorted_w), 4)
    want = gm_merge_pallas_batch_packed_4d(jnp.asarray(planes.numpy()), 2.0,
                                           128, interpret=True,
                                           sorted_w=sorted_w)
    assert_merges_close([x.numpy() for x in got],
                        [np.asarray(x) for x in want], cov_rtol=1e-3)
    assert (got[3] > 10).all()


def test_merge3d_twin_above_the_narrow_width_matches_pallas():
    """N = 2304 > 2048 weight-sorted 3D (u, v, d) lanes at the disparity
    path's min_separation 20, against _merge_kernel_3d (r_par 8)."""
    N = NARROW_LANES[3] + 256
    planes = merge3d_inputs(CPU, P=2, N=N, seed=3)
    got = merge_out(merge3d(planes, 20.0, 24), 3)
    mean, cov, w, act = (jnp.asarray(x.numpy())
                         for x in unpack_planes(planes, 3))
    want = gm_merge_pallas_batch_3d(mean, cov, w, act, 20.0, 24,
                                    interpret=True, sorted_w=True)
    assert_merges_close([x.numpy() for x in got],
                        [np.asarray(x) for x in want], cov_rtol=1e-3)
    assert (got[3] > 5).all()


def detect_planes(K, P=2, M=8, seed=0):
    """Random detection planes [P, 6, K] (70% of the features weighted)
    and z4 [M, 4] with M - 2 valid measurements (numpy)."""
    rng = np.random.default_rng(seed)
    planes = np.stack([
        rng.uniform(1, 10, (P, K)), rng.uniform(-np.pi, np.pi, (P, K)),
        rng.uniform(0.5, 4.0, (P, K)), rng.uniform(-0.2, 0.2, (P, K)),
        rng.uniform(0.5, 4.0, (P, K)),
        np.where(rng.uniform(size=(P, K)) < 0.7,
                 rng.uniform(0.01, 1.0, (P, K)), 0.0)], axis=1)
    z4 = np.stack([rng.uniform(1, 10, M), rng.uniform(-np.pi, np.pi, M),
                   (np.arange(M) < M - 2).astype(float), np.zeros(M)],
                  axis=1)
    return planes.astype(np.float32), z4.astype(np.float32)


@pytest.mark.parametrize("T,min_fw", [(16, 1e-4), (40, 0.0)])
def test_detect_twin_above_the_narrow_width_matches_pallas(T, min_fw):
    """K = 2048 > 1024 features, P = 2, M = 8: the twin against the Pallas
    detect kernel in interpret mode (a thresholded T = 16, and T = 40 at
    min_fw 0, the wide kernel's trips): normalizers and values rtol 1e-6,
    indices where selected and counts exactly."""
    K = 2 * NARROW_FEATURES
    planes, z4 = detect_planes(K)
    want = [np.asarray(x) for x in detection_topT_batch(
        jnp.asarray(planes), jnp.asarray(z4), T, min_fw, 0.05,
        interpret=True)]
    got = [x.numpy() for x in detect(torch.from_numpy(planes),
                                     torch.from_numpy(z4), T, min_fw, 0.05)]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got[3], want[3])
    sel = want[0] > 0
    np.testing.assert_array_equal(got[1][sel], want[1][sel])
    assert (got[1][~sel] == 0).all()
    assert (got[3] > 0).any()
    if min_fw == 0.0:
        assert (got[3] > 32).any()


def cons_detect_planes(K, P=2, M=8, seed=0):
    """detect_planes' [P, 6, K] with the 7 consolidation planes after them
    (wp on half the features, then the copy-copy and copy-persistent
    quadratics q00 q01 q11, p00 p01 p11), as detect_bench's consolidating
    edge cases draw them: planes [P, 13, K] and z4 (numpy)."""
    planes, z4 = detect_planes(K, P, M, seed)
    rng = np.random.default_rng(seed + 1)
    wp = np.where(rng.uniform(size=(P, K)) < 0.5,
                  rng.uniform(0.01, 1.0, (P, K)), 0.0)
    quads = [f(size=(P, K)) for _ in range(2) for f in (
        lambda size: rng.uniform(0.02, 0.5, size),
        lambda size: rng.uniform(-0.01, 0.01, size),
        lambda size: rng.uniform(0.02, 0.5, size))]
    extra = np.stack([wp, *quads], axis=1).astype(np.float32)
    return np.concatenate([planes, extra], axis=1), z4


@pytest.mark.parametrize("adaptive", [False, True])
def test_detect_cons_twin_above_the_narrow_width_matches_pallas(adaptive):
    """K = 2048 > 1024 features, P = 2, M = 8, consolidating (min_sep 2),
    static and adaptive: the twin against the Pallas detect kernel's
    cons_ref branch in interpret mode. Normalizers, values and the cons
    sums rtol 1e-6 (the sums also atol 1e-8: the signed moments cancel
    to ~1e-4 of their terms, which XLA and PyTorch add in other orders),
    indices where selected, counts, member counts, head coordinates and
    pers_in exactly."""
    K, T, min_fw, cb, min_sep = 2 * NARROW_FEATURES, 16, 1e-4, 0.05, 2.0
    planes, z4 = cons_detect_planes(K)
    want = [np.asarray(x) for x in detection_topT_batch(
        jnp.asarray(planes), jnp.asarray(z4), T, min_fw, cb,
        interpret=True, min_sep=min_sep, adaptive=adaptive)]
    got = [x.numpy() for x in detect(torch.from_numpy(planes),
                                     torch.from_numpy(z4), T, min_fw, cb,
                                     min_sep=min_sep, adaptive=adaptive)]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got[3], want[3])
    sel = want[0] > 0
    np.testing.assert_array_equal(got[1][sel], want[1][sel])
    assert (got[1][~sel] == 0).all()
    np.testing.assert_array_equal(got[4][:, 6:], want[4][:, 6:])
    np.testing.assert_allclose(got[4][:, :6], want[4][:, :6], rtol=1e-6,
                               atol=1e-8)
    assert (got[3] > 0).any() and (got[4][:, 8] > 1).any()


# the mixed bench's widths (tools/bench_mixed.py: K = 128, M = 32) with the
# candidate cap off: the per-particle route over the full grid, 128 + 32 *
# 128 + 32 = 4256 lanes a map (merge2d's argmax mode is narrow there,
# merge4d's takes its staged variant on the card)
MIXED_FULL = dict(MIXED_STEP, n_particles=2, max_features=128,
                  max_measurements=32, merge_candidate_cap=0)


def test_mixed_full_grid_step_matches_jax():
    """One mixed phd_step on the full grid at the bench's widths from the
    same state with JAX's replayed draws: poses within 1e-5, both maps
    and the log weights rtol 1e-4 / atol 1e-5, the same ancestors and
    overflow."""
    jcfg = JaxSlamConfig(**MIXED_FULL)
    tcfg = SlamConfig(**MIXED_FULL)
    K, M = tcfg.max_features, tcfg.max_measurements
    check_supported(tcfg, K, M)
    assert not uses_fast_route(tcfg, K, M)
    assert K + M * K + M == 4256 > NARROW_LANES[4]
    w = jax_mixed_world(24, 4, 2, 0.15, 3, M)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_state_arrays(js, dynamic=True))
    ctrl = np.zeros(2, np.float32)
    for n in range(2):
        z, zm = w["z_all"][n], w["mask_all"][n]
        noise = replay_noise(js, jcfg)
        js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                        jnp.asarray(ctrl), jnp.float32(0.15),
                        jnp.asarray(n > 0))
        ts, tout = phd_step(ts, t(z), t(zm), (0.0, 0.0), 0.15, n > 0, tcfg,
                            noise)
        got, want = state_to_numpy(ts), jax_state_arrays(js, dynamic=True)
        close(got["pose"], want["pose"], rtol=0, atol=1e-5,
              msg=f"pose step {n}")
        assert_states_close(got, want, msg=f"step {n}")
        np.testing.assert_array_equal(got["resample_idx"],
                                      want["resample_idx"])
        assert int(tout.overflow) == int(jout.overflow)
    assert (got["map_weight"] > 0).sum(axis=1).min() > 0
    assert (got["dyn_weight"] > 0).sum(axis=1).min() > 0

