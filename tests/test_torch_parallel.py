"""The port's multi-process runtime (``phdslam_tpu_torch/parallel``)
against the JAX package's multi-device code, on the CPU.

Units: the migration's feasibility test and row budget against
``phdslam_tpu/parallel/migrate.py`` exactly; the neighbour exchange over
four Gloo ranks against JAX's ``gather_rows_neighbor`` on a 4-device mesh
and against ``x[anc]``, bit for bit; the mesh, the sharding of a state
and of a step's draws; ``init_sharded_state`` and ``initialize`` where
JAX's refuse or decline.

Steps: JAX's ``make_sharded_step_fn`` on ``make_mesh(size)`` (the 8
virtual CPU devices of tests/conftest.py) runs the small scene of
tests/test_sharding.py for a few steps in each variant (plain, forced
resampling, CPHD, mixed, mixed with two-scan velocity births, EAP), and
``make_sharded_disparity_step_fn`` the disparity scene of
tests/test_torch_disparity.py; the draws each step made
(``test_torch_step.replay_noise``) go with the inputs and the initial
state into ``parallel/sim.py``'s "replay" task, which steps the port's
sharded step on ``size`` Gloo ranks, each step from JAX's state before
it (as the unsharded step tests resync: an f32 difference of an earlier
step can move a merge across its threshold). Every step's gathered state
and outputs are held to JAX's within JAX's own sharded tolerances
(tests/test_sharding.py: rtol 2e-4 / atol 2e-5, map weights 2e-3).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.parallel import init_sharded_state as jax_init_sharded
from phdslam_tpu.parallel import make_mesh as jax_make_mesh
from phdslam_tpu.parallel import make_sharded_step_fn as jax_sharded_step
from phdslam_tpu.parallel import migrate as jmig
from phdslam_tpu.parallel.sharding import (
    init_sharded_disparity_state as jax_init_sharded_disparity,
    make_sharded_disparity_step_fn as jax_sharded_disparity_step)
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters.disparity import DisparityNoise
from phdslam_tpu_torch.filters.phd import StepNoise
from phdslam_tpu_torch.parallel import distributed, migrate, sharding
from phdslam_tpu_torch.parallel.sim import run_group
from phdslam_tpu_torch.types import init_state

from test_torch_disparity import DISP, assert_states_close, jax_arrays, scans
from test_torch_disparity import replay_noise as disparity_noise
from test_torch_step import (assert_log_card_close, jax_state_arrays,
                             replay_noise)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (2, 4)
N_STEPS = 4
RTOL, ATOL, MAP_RTOL, MAP_ATOL = 2e-4, 2e-5, 2e-3, 1e-5
# tests/test_sharding.py's small_cfg and variants, JAX's Pallas kernels in
# interpret mode (the kernels the port's replace; at this cap the mixed
# update takes the per-particle route, where JAX's XLA merge and its Pallas
# 4D kernel part on which births merge)
SMALL = dict(n_particles=16, max_features=12, max_measurements=4,
             motion_type=0, feature_model=0, filter_type=0, max_range=15.0,
             std_range=0.25, std_bearing=0.02, clutter_rate=5.0, pd=0.95,
             birth_weight=0.05, min_separation=2.0, resample_threshold=0.5,
             seed=3, pallas_merge=2, pallas_detect=2)
# The mixed variants add the dynamic map's birth velocity and process
# covariances of tests/test_torch_mixed.py's MIXED_STEP: left at 0 (as
# small_cfg leaves them) every 4D covariance is singular, a merge's
# Mahalanobis distance is then a rounding artefact (1e9 of either sign
# past the determinant clamp), and one f32 rounding in another order
# flips which births merge (JAX's XLA merge and its own 4D kernel differ
# there too).
MIXED_COVS = dict(cov_vx_birth=0.25, cov_vy_birth=0.25, std_ax_map=0.01,
                  std_ay_map=0.01)
VARIANTS = {
    "plain": {},
    "forced": dict(resample_threshold=2.0),
    "cphd": dict(filter_type=1, max_cardinality=24),
    "mixed": dict(feature_model=2, **MIXED_COVS),
    "mixed_velinit": dict(feature_model=2, birth_velocity_init=1,
                          resample_threshold=1.1, **MIXED_COVS),
    "eap": dict(map_estimate=2, particle_weighting=0),
}
DISP_SHARDED = dict(DISP, n_particles=8, resample_threshold=1.1)


def fake_inputs(m_max, n_z=3):
    z = np.zeros((m_max, 2), np.float32)
    z[:n_z] = [[5.0, 0.1], [8.0, -0.4], [3.0, 1.0]][:n_z]
    mask = np.zeros((m_max,), bool)
    mask[:n_z] = True
    return z, mask


def jax_arrays_of(js, cfg):
    out = jax_state_arrays(js, dynamic=cfg.feature_model in (1, 2))
    if js.prev_z is not None:
        out["prev_z"] = np.asarray(js.prev_z)
    return out


def record_variant(name, size, path):
    """JAX's sharded steps of one variant on make_mesh(size): the port's
    replay inputs into ``path`` (npz) and JAX's per-step results."""
    fields = dict(SMALL, **VARIANTS[name])
    jcfg = JaxSlamConfig(**fields)
    mesh = jax_make_mesh(size)
    step = jax_sharded_step(jcfg, mesh, donate=False)
    js = jax_init_sharded(jcfg, mesh)
    z, zm = fake_inputs(jcfg.max_measurements)
    rec = {}
    keys = ("z", "z_mask", "control", "dt", "do_predict", "eps_pred",
            "u_resample")
    seq = {k: [] for k in keys}
    want = []
    for n in range(N_STEPS):
        rec.update({f"s{n}_{k}": v for k, v in jax_arrays_of(js, jcfg).items()})
        noise = replay_noise(js, jcfg)
        js, out = step(js, jnp.asarray(z), jnp.asarray(zm),
                       jnp.zeros((2,), jnp.float32), jnp.float32(0.1),
                       jnp.asarray(n > 0))
        for k, v in zip(keys, (z, zm, np.zeros(2, np.float32), 0.1, n > 0,
                               noise.eps_pred.numpy(),
                               noise.u_resample.numpy())):
            seq[k].append(v)
        want.append((jax_arrays_of(js, jcfg),
                     jax.tree.map(np.asarray, out)))
    rec.update({k: np.asarray(v) for k, v in seq.items()})
    np.savez(path, **rec)
    return {"kind": "replay", "fields": fields, "npz": str(path)}, want


def record_disparity(size, path):
    jcfg = JaxSlamConfig(**DISP_SHARDED)
    mesh = jax_make_mesh(size)
    step = jax_sharded_disparity_step(jcfg, mesh, donate=False)
    js = jax_init_sharded_disparity(jcfg, mesh)
    z_all, mask_all, _ = scans()
    rec = {}
    seq = {k: [] for k in ("z", "z_mask", "dt", "do_predict", "eps_pred",
                           "eps_sample", "u_resample")}
    want = []
    for n in range(N_STEPS):
        rec.update({f"s{n}_{k}": v for k, v in jax_arrays(js).items()})
        noise = disparity_noise(js, jcfg.max_features,
                                jcfg.particles_per_feature)
        js, out = step(js, jnp.asarray(z_all[n]), jnp.asarray(mask_all[n]),
                       jnp.float32(jcfg.dt), jnp.asarray(n > 0))
        for k, v in (("z", z_all[n]), ("z_mask", mask_all[n]),
                     ("dt", jcfg.dt), ("do_predict", n > 0),
                     ("eps_pred", noise.eps_pred.numpy()),
                     ("eps_sample", noise.eps_sample.numpy()),
                     ("u_resample", noise.u_resample.numpy())):
            seq[k].append(v)
        want.append((jax_arrays(js), jax.tree.map(np.asarray, out)))
    rec.update({k: np.asarray(v) for k, v in seq.items()})
    np.savez(path, **rec)
    return {"kind": "replay", "fields": DISP_SHARDED, "npz": str(path)}, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mesh size: JAX's recorded runs of every variant and the
    disparity scene, and the port's replay of all of them in one group of
    ``size`` Gloo ranks. Returns {size: {case: (want, arrays)}}."""
    out = {}
    for size in SIZES:
        tmp = tmp_path_factory.mktemp(f"size{size}")
        cases, tasks = {}, []
        for name in VARIANTS:
            task, want = record_variant(name, size, tmp / f"{name}.npz")
            cases[name] = want
            tasks.append(task)
        task, want = record_disparity(size, tmp / "disparity.npz")
        cases["disparity"] = want
        tasks.append(task)
        res = run_group(size, {"kind": "each", "tasks": tasks},
                        device="cpu", timeout_s=240)
        arrays = res[0]["arrays"]
        out[size] = {name: (want, {k[len(f"t{i}_"):]: v
                                   for k, v in arrays.items()
                                   if k.startswith(f"t{i}_")})
                     for i, (name, want) in enumerate(cases.items())}
        out[size]["_results"] = res[0]["results"]
    return out


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def close_map(g_w, g_mean, w_w, w_mean, rtol=MAP_RTOL, atol=2e-4, msg=""):
    """Map components slot by slot, a slot free to hold another component
    whose weight ties with its own within the tolerance (the tree's
    compaction sorts by weight, and tied weights round into either
    order)."""
    ok = np.isclose(g_mean, w_mean, rtol=rtol, atol=atol).all(axis=-1)
    for k in np.flatnonzero(~ok):
        tied = np.isclose(w_w, g_w[k], rtol=rtol, atol=MAP_ATOL)
        same = np.isclose(w_mean, g_mean[k], rtol=rtol, atol=atol).all(-1)
        assert (tied & same).any(), f"{msg}: slot {k}"


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_step_matches_jax(runs, size, variant):
    """The port's sharded step on ``size`` Gloo ranks against JAX's sharded
    step on make_mesh(size), every step from JAX's recorded draws."""
    want, got = runs[size][variant]
    cfg = SlamConfig(**dict(SMALL, **VARIANTS[variant]))
    resampled = 0
    for n, (ws, wo) in enumerate(want):
        g = {k[len(f"step{n}_"):]: v for k, v in got.items()
             if k.startswith(f"step{n}_")}
        msg = f"{variant} size {size} step {n}"
        np.testing.assert_array_equal(g["resample_idx"], ws["resample_idx"],
                                      err_msg=msg)
        for k in ("pose", "log_weight"):
            close(g[k], ws[k], msg=f"{k} {msg}")
        close(g["map_weight"], ws["map_weight"], MAP_RTOL, MAP_ATOL,
              msg=f"map_weight {msg}")
        if cfg.feature_model == 2:
            close(g["dyn_weight"], ws["dyn_weight"], MAP_RTOL, MAP_ATOL,
                  msg=f"dyn_weight {msg}")
        if "prev_z" in ws:
            close(g["prev_z"], ws["prev_z"], msg=f"prev_z {msg}")
        close(g["out_expected_pose"], wo.expected_pose, msg=msg)
        close(g["out_n_eff"], wo.n_eff, msg=msg)
        assert bool(g["out_resampled"]) == bool(wo.resampled), msg
        assert int(g["out_overflow"]) == int(wo.overflow), msg
        close(g["out_map_weight"], wo.map_weight, MAP_RTOL, MAP_ATOL,
              msg=f"out map_weight {msg}")
        if variant == "eap":
            close_map(g["out_map_weight"], g["out_map_mean"], wo.map_weight,
                      wo.map_mean, msg=f"EAP map {msg}")
        if cfg.filter_type == 1:
            assert_log_card_close(g["cardinality"], ws["cardinality"],
                                  f"cardinality {msg}")
            assert_log_card_close(g["out_cardinality"][None],
                                  wo.cardinality[None],
                                  f"MAP cardinality {msg}")
        resampled += bool(wo.resampled)
    if variant in ("forced", "mixed_velinit"):
        assert resampled >= N_STEPS - 1      # the migration ran
    assert (got[f"step{N_STEPS - 1}_map_weight"] > 0).any()


@pytest.mark.parametrize("size", SIZES)
def test_sharded_disparity_matches_jax(runs, size):
    """The port's sharded SC-PHD step against JAX's
    make_sharded_disparity_step_fn, resampling forced on every step so the
    cloud leaf migrates: states within the unsharded disparity step test's
    gates (``test_torch_disparity.assert_states_close``: poses 1e-5, log
    and feature weights rtol 1e-4 / atol 1e-5, clouds in disparity space),
    outputs within JAX's sharded tolerances."""
    want, got = runs[size]["disparity"]
    cfg = SlamConfig(**DISP_SHARDED)
    for n, (ws, wo) in enumerate(want):
        g = {k[len(f"step{n}_"):]: v for k, v in got.items()
             if k.startswith(f"step{n}_")}
        msg = f"disparity size {size} step {n}"
        assert_states_close(g, ws, cfg, msg=msg)
        close(g["out_expected_pose"], wo.expected_pose, msg=msg)
        close(g["out_map_weight"], wo.map_weight, msg=msg)
        assert bool(g["out_resampled"]) and bool(wo.resampled), msg
    migrations = runs[size]["_results"][-1]["migrations"]
    assert migrations.get("neighbour" if size > 2 else "full", 0) > 0


# ----------------------------------------------------------------------------
# the migration
# ----------------------------------------------------------------------------

def equilibrium_ancestry(P, rng, max_shift=3):
    """tests/test_migrate.py's sorted ancestry with small local repeats."""
    anc = np.arange(P)
    for _ in range(max_shift):
        i = rng.integers(0, P)
        j = rng.integers(max(0, i - 4), min(P, i + 4))
        anc[i] = anc[j]
    return np.sort(anc).astype(np.int32)


def ancestries():
    rng = np.random.default_rng(0)
    far = np.arange(64, dtype=np.int32)
    far[0] = 63                       # rank 0 needs a row of the last rank
    skew = np.arange(64, dtype=np.int32)
    skew[8:16] = np.arange(8)         # a whole block from its neighbour
    return {"equilibrium": (equilibrium_ancestry(64, rng, 10), 8, None),
            "equilibrium_4": (equilibrium_ancestry(64, rng, 20), 4, None),
            "far": (far, 8, None), "skew_budget2": (skew, 8, 2),
            "skew_budget8": (skew, 8, 8),
            "identity": (np.arange(64, dtype=np.int32), 4, 1)}


@pytest.mark.parametrize("case", list(ancestries()))
def test_neighbor_feasible_matches_jax(case):
    anc, n_dev, budget = ancestries()[case]
    block = 64 // n_dev
    budget = budget or migrate.default_row_budget(block)
    want = bool(jmig.neighbor_feasible(jnp.asarray(anc), n_dev, block,
                                       budget))
    got = bool(migrate.neighbor_feasible(torch.from_numpy(anc), n_dev,
                                         block, budget))
    assert got == want
    if case.startswith("equilibrium"):
        assert got
    if case in ("far", "skew_budget2"):
        assert not got


@pytest.mark.parametrize("block", [1, 4, 15, 16, 17, 64, 128, 1000])
def test_default_row_budget_matches_jax(block):
    assert migrate.default_row_budget(block) == jmig.default_row_budget(block)


def spawn_ranks(code, n, tmp_path, timeout=120, env_of=None):
    """Run ``code`` (a script reading RANK, WORLD and STORE from argv) on
    ``n`` processes over a file:// store, within ``timeout`` s for the
    group; fail with the first failing rank's output. ``env_of(rank)``:
    environment variables added for that rank."""
    script = tmp_path / "rank.py"
    script.write_text(code)
    store = "file://" + str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(n),
                               store], cwd=REPO,
                              env=dict(env, **(env_of(r) if env_of else {})),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"


NEIGHBOR_RANK = """
import sys
import numpy as np
import torch
from phdslam_tpu_torch.parallel import distributed
from phdslam_tpu_torch.parallel.migrate import gather_rows_neighbor
from phdslam_tpu_torch.parallel.sharding import make_mesh
rank, n, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
distributed.initialize(store, n, rank, "gloo", "cpu", 60)
mesh = make_mesh(device="cpu")
data = np.load("{inp}")
anc = torch.from_numpy(data["anc"])
L = anc.shape[0] // n
leaves = [torch.from_numpy(data[k][rank * L:(rank + 1) * L])
          for k in ("a", "b", "c")]
got = gather_rows_neighbor(mesh, anc, leaves, int(data["budget"]))
np.savez("{out}" + str(rank) + ".npz", *[g.numpy() for g in got])
torch.distributed.destroy_process_group()
"""


def test_gather_rows_neighbor_matches_jax(tmp_path):
    """Four Gloo ranks' neighbour exchange against JAX's shard_map exchange
    on a 4-device mesh, and both against x[anc], bit for bit."""
    P, K, n = 64, 12, 4
    rng = np.random.default_rng(0)
    anc = equilibrium_ancestry(P, rng, max_shift=10)
    block = P // n
    budget = migrate.default_row_budget(block)
    # rows crossing both ring edges
    anc[block - 1], anc[block] = block, block - 1
    anc = np.sort(anc).astype(np.int32)
    assert bool(jmig.neighbor_feasible(jnp.asarray(anc), n, block, budget))
    leaves = [rng.normal(0, 1, (P, K, 2)).astype(np.float32),
              rng.normal(0, 1, (P,)).astype(np.float32),
              rng.normal(0, 1, (P, K, 2, 2)).astype(np.float32)]
    mesh = jax_make_mesh(n)
    want = jax.jit(lambda a, *xs: jmig.gather_rows_neighbor(
        mesh, a, list(xs), budget))(jnp.asarray(anc),
                                    *map(jnp.asarray, leaves))
    inp = tmp_path / "in.npz"
    np.savez(inp, anc=anc, a=leaves[0], b=leaves[1], c=leaves[2],
             budget=budget)
    spawn_ranks(NEIGHBOR_RANK.format(inp=inp, out=tmp_path / "out"), n,
                tmp_path)
    got = [np.load(tmp_path / f"out{r}.npz") for r in range(n)]
    assert any((anc[r * block:(r + 1) * block] // block != r).any()
               for r in range(n))          # some rows cross ranks
    for i, (w, x) in enumerate(zip(want, leaves)):
        g = np.concatenate([z[f"arr_{i}"] for z in got])
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, x[anc])


# ----------------------------------------------------------------------------
# the mesh, the sharding and the runtime's refusals
# ----------------------------------------------------------------------------

def test_init_sharded_state_refuses_remainder():
    """As JAX's: P % size != 0 is refused, not padded."""
    mesh = sharding.Mesh(size=4, rank=0, device=torch.device("cpu"),
                         backend="gloo")
    with pytest.raises(ValueError):
        sharding.init_sharded_state(SlamConfig(**SMALL), mesh, 10)
    with pytest.raises(ValueError):
        mesh.block(10)
    st = sharding.init_sharded_state(SlamConfig(**SMALL), mesh, 16)
    assert st.pose.shape[0] == 4 and st.map_static.mean.shape[0] == 4


def test_init_sharded_disparity_state_takes_the_rank_block():
    from phdslam_tpu_torch.filters.disparity import init_disparity_state
    cfg = SlamConfig(**DISP_SHARDED)
    eps = torch.randn((cfg.n_particles, 2),
                      generator=torch.Generator().manual_seed(0))
    mesh = sharding.Mesh(size=2, rank=1, device=torch.device("cpu"),
                         backend="gloo")
    got = sharding.init_sharded_disparity_state(cfg, mesh, eps)
    full = init_disparity_state(cfg, eps)
    for k in ("cam_pose", "log_weight", "cloud", "feat_weight",
              "resample_idx"):
        torch.testing.assert_close(getattr(got, k), getattr(full, k)[4:])
    with pytest.raises(ValueError):
        sharding.init_sharded_disparity_state(
            SlamConfig(**dict(DISP_SHARDED, n_particles=7)), mesh,
            eps[:7])


def test_initialize_without_launcher(monkeypatch):
    """No launcher environment and no coordinator: False, nothing
    initialized, no mesh (the unsharded path; JAX test_sharding.py:134)."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    assert distributed.global_mesh("cpu") is None
    assert sharding.make_mesh(1, device="cpu") is None
    assert distributed.process_local_batch(64) == 64
    with pytest.raises(ValueError):
        sharding.make_mesh(2, device="cpu")


LAUNCHER_RANK = """
import sys
import torch
from phdslam_tpu_torch.parallel import distributed
from phdslam_tpu_torch.parallel.sharding import make_mesh
assert distributed.initialize(device="cpu") is True
mesh = distributed.global_mesh("cpu")
assert (mesh.size, mesh.transport) == (2, "gloo"), mesh
assert mesh.rank == int(sys.argv[1]) and distributed.is_primary() == (
    mesh.rank == 0)
got = mesh.all_gather(torch.tensor([float(mesh.rank)]))
assert got.tolist() == [0.0, 1.0], got
assert distributed.process_local_batch(8) == 4
torch.distributed.destroy_process_group()
"""


def test_initialize_under_a_launcher_environment(tmp_path):
    """torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT; a localhost TCP store) initializes a Gloo group on the
    CPU: True, a mesh of both ranks."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def env_of(r):
        return {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
                "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(port)}
    spawn_ranks(LAUNCHER_RANK, 2, tmp_path, env_of=env_of)


def test_backend_follows_the_device():
    assert distributed.backend_for("cuda") == "nccl"
    assert distributed.backend_for("cpu") == "gloo"
    assert distributed.backend_for("cuda", "gloo") == "gloo"
    with pytest.raises(ValueError):
        distributed.backend_for("cpu", "nccl")
    with pytest.raises(ValueError):
        distributed.backend_for("cpu", "mpi")


@pytest.mark.parametrize("variant", ["plain", "cphd", "mixed_velinit"])
def test_shard_state_takes_each_rank_block(variant):
    """Every per-particle leaf (pose, log_weight, both maps, cardinality,
    variance, prev_z, resample_idx) sliced to the rank's rows."""
    cfg = SlamConfig(**dict(SMALL, **VARIANTS[variant]))
    full = init_state(cfg)
    full = sharding.map_leaves(full, lambda x: torch.arange(
        x.numel(), dtype=x.dtype).view(x.shape))
    mesh = sharding.Mesh(size=4, rank=2, device=torch.device("cpu"),
                         backend="gloo")
    got = dict(sharding.particle_leaves(sharding.shard_state(mesh, full)))
    want = dict(sharding.particle_leaves(full))
    assert got.keys() == want.keys()
    assert ("variance",) in got
    if variant == "mixed_velinit":
        assert ("prev_z",) in got and ("map_dynamic", "mean") in got
    for k, v in want.items():
        torch.testing.assert_close(got[k], v[8:12], rtol=0, atol=0)


def test_local_noise_keeps_the_rank_rows():
    """The global draws sliced to the rank's rows: the prediction draws of
    its P k particles, the resampling uniforms whole, the variance
    samples in either estimator layout, disparity draws by particle."""
    mesh = sharding.Mesh(size=4, rank=1, device=torch.device("cpu"),
                         backend="gloo")
    g = torch.Generator().manual_seed(0)
    eps = torch.randn((2, 16, 3), generator=g)
    u = torch.rand((16,), generator=g)
    grid = torch.randn((16, 20, 2), generator=g)
    lanes = torch.randn((2, 16, 20), generator=g)

    def draw(s, shape):
        return {(16, 20, 2): grid, (2, 16, 20): lanes}[tuple(shape)]
    loc = sharding.local_noise(StepNoise(eps, u, draw), mesh)
    torch.testing.assert_close(loc.eps_pred, eps[:, 4:8])
    assert loc.u_resample is u
    torch.testing.assert_close(loc.var_draw(0, (4, 20, 2)), grid[4:8])
    torch.testing.assert_close(loc.var_draw(0, (2, 4, 20)), lanes[:, 4:8])
    with pytest.raises(ValueError):
        loc.var_draw(0, (5, 20, 2))
    d = DisparityNoise(torch.randn(16, 6), torch.randn(16, 3, 4, 3), u)
    dl = sharding.local_noise(d, mesh)
    torch.testing.assert_close(dl.eps_sample, d.eps_sample[4:8])
    torch.testing.assert_close(dl.eps_pred, d.eps_pred[4:8])
    assert sharding.local_noise(d, None) is d
