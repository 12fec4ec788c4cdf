"""Particle shotgunning (n_predict_particles = k > 1) step by step against
the JAX package: every particle repeated k times before prediction with
log weights - log k, prediction at P k, the update and extraction over the
P k copies and the forced systematic contraction back to P at the end of
every step.

The PHD and CPHD cases replay ``data/ackerman`` (``test_torch_step.
replay_dataset``, JAX's draws with P k prediction rows), the mixed case
the mixed world of ``test_torch_mixed`` on its fast route.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.eval.parity import _mixed_world as jax_mixed_world
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters.phd import phd_step
from phdslam_tpu_torch.types import state_from_jax, state_to_numpy
from test_torch_mixed import MIXED_STEP, assert_states_close, close, t
from test_torch_step import (CFG, DATA, SMALL, jax_state_arrays,
                             replay_dataset, replay_noise)

K_SHOT = 3
K = SMALL["max_features"]


@pytest.mark.parametrize("cfg_path,over", [
    (CFG, {}), ("cfg/ackerman_cphd.cfg", {"detection_topk": K})],
    ids=["phd", "cphd"])
def test_shotgun_step_matches_jax(cfg_path, over):
    """Five steps at P=8, k=3: the state (P=8 after each contraction),
    resampling ancestors over the 24 copies and the outputs equal to
    JAX's; every step resamples with uniform weights. The CPHD case takes
    the top-cap lane route: on its det route the overflow count holds the
    detect kernel's lanes with pdw > 0 at min_fw 0, subnormal ones
    included, which XLA's CPU exp flushes to zero (the 24 copies reach
    such lanes at step 3; the card holds that route under shotgunning
    against the CPU twins)."""
    ts, resampled = replay_dataset(
        cfg_path, DATA, dict(SMALL, n_predict_particles=K_SHOT, **over), 5)
    got = state_to_numpy(ts)
    assert got["pose"].shape[0] == SMALL["n_particles"] and all(resampled)
    np.testing.assert_allclose(got["log_weight"],
                               -np.log(SMALL["n_particles"]), rtol=1e-6)
    assert got["resample_idx"].max() < SMALL["n_particles"] * K_SHOT


def test_shotgun_mixed_step_matches_jax():
    """The mixed fast route at k=3: both maps, the poses and the
    contraction's ancestors over the 24 copies against JAX's step."""
    dt, n_steps = 0.15, 6
    cfg = dict(MIXED_STEP, n_predict_particles=K_SHOT)
    w = jax_mixed_world(8, 2, n_steps, dt, 3, 8)
    jcfg, tcfg = JaxSlamConfig(**cfg), SlamConfig(**cfg)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_state_arrays(js, dynamic=True))
    for n in range(n_steps):
        z, zm = w["z_all"][n], w["mask_all"][n]
        noise = replay_noise(js, jcfg)
        js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                        jnp.zeros(2, jnp.float32), jnp.float32(dt),
                        jnp.asarray(n > 0))
        ts, tout = phd_step(ts, t(z), t(zm), (0.0, 0.0), dt, n > 0, tcfg,
                            noise)
        got, want = state_to_numpy(ts), jax_state_arrays(js, dynamic=True)
        close(got["pose"], want["pose"], rtol=0, atol=1e-5,
              msg=f"pose step {n}")
        assert_states_close(got, want, msg=f"step {n}")
        np.testing.assert_array_equal(got["resample_idx"],
                                      want["resample_idx"])
        assert int(tout.overflow) == int(jout.overflow)
        close(tout.expected_pose, jout.expected_pose, rtol=1e-4, atol=1e-5)
        close(tout.n_eff, jout.n_eff, rtol=1e-4)
    assert (state_to_numpy(ts)["dyn_weight"] > 0).sum(axis=1).min() > 0
