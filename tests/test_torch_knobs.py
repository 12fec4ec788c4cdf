"""Replayed filter steps of the port against the JAX package with the kernel
knobs on: detect_adaptive on a CPHD and a mixed step, and each of
detect_adaptive, premerge_consolidate and fused_gather_merge on the dense
configuration (``cfg/dense.cfg`` on ``data/dense``) narrowed to a CPU size
(K=64, M=16, T=8, cap 96, P=8).

The same initial state and JAX's replayed draws go through both packages'
``phd_step`` (``tests/test_torch_step.py::replay_dataset``): poses, weights
and maps to rtol 1e-4 / atol 1e-5, the resampling decision and ancestors
and the overflow count exactly. The JAX Pallas kernels run in interpret
mode (pallas_detect=2, pallas_merge=2); the port's wrappers run their
plain twins on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters.phd import phd_step
from phdslam_tpu_torch.types import state_from_jax, state_to_numpy
from test_torch_cphd import STEP, flush_subnormals  # noqa: F401 (fixture)
from test_torch_mixed import MIXED_STEP, close, jax_mixed_world
from test_torch_step import jax_state_arrays, replay_dataset, replay_noise

# cfg/dense.cfg cut to a CPU size; merge_r_par=1: the Pallas merge emits
# the same clusters for any R and compiles faster in interpret mode
DENSE = dict(n_particles=8, max_features=64, max_measurements=16,
             detection_topk=8, merge_candidate_cap=96, pallas_detect=2,
             pallas_merge=2, merge_r_par=1)


@pytest.mark.parametrize("knob", ["detect_adaptive", "premerge_consolidate",
                                  "fused_gather_merge"])
def test_dense_step_with_knob_matches_jax(knob):
    """Three replayed steps of the narrowed dense configuration with one
    knob on in both packages."""
    ts, _ = replay_dataset("cfg/dense.cfg", "data/dense",
                           dict(DENSE, **{knob: 1}), 3)
    assert (state_to_numpy(ts)["map_weight"] > 0).sum(axis=1).min() > 8


def test_cphd_step_adaptive_matches_jax(flush_subnormals):  # noqa: F811
    """Two replayed CPHD steps (cfg/ackerman_cphd.cfg on data/ackerman,
    the det route) with detect_adaptive=1."""
    ts, _ = replay_dataset("cfg/ackerman_cphd.cfg", "data/ackerman",
                           dict(STEP, detect_adaptive=1), 2)
    card = state_to_numpy(ts)["cardinality"]
    np.testing.assert_allclose(np.exp(card).sum(axis=1), 1.0, rtol=1e-4)


def test_mixed_step_adaptive_matches_jax():
    """Three replayed mixed steps (both maps' detects) with
    detect_adaptive=1."""
    dt, n_steps = 0.15, 3
    cfg = dict(MIXED_STEP, detect_adaptive=1)
    w = jax_mixed_world(8, 2, n_steps, dt, 3, 8)
    jcfg, tcfg = JaxSlamConfig(**cfg), SlamConfig(**cfg)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_state_arrays(js, dynamic=True))
    for n in range(n_steps):
        z, zm = w["z_all"][n], w["mask_all"][n]
        noise = replay_noise(js, jcfg)
        js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                        jnp.asarray(np.zeros(2, np.float32)),
                        jnp.float32(dt), jnp.asarray(n > 0))
        ts, tout = phd_step(ts, torch.from_numpy(z), torch.from_numpy(zm),
                            (0.0, 0.0), dt, n > 0, tcfg, noise)
        got, want = state_to_numpy(ts), jax_state_arrays(js, dynamic=True)
        for name in ("pose", "log_weight", "map_weight", "map_mean",
                     "dyn_weight", "dyn_mean"):
            close(got[name], want[name], rtol=1e-4, atol=1e-5,
                  msg=f"{name} step {n}")
        np.testing.assert_array_equal(got["resample_idx"],
                                      want["resample_idx"])
        assert int(tout.overflow) == int(jout.overflow)
    assert (state_to_numpy(ts)["dyn_weight"] > 0).sum(axis=1).min() > 0
