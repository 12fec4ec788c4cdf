"""The spatially tiled merge (merge_spatial_tiles = 4) of the port against
the JAX package, on the CPU.

The merge alone: the port's ``filters/phd.py::merge_packed`` on a
:class:`TileRoute` of fixed width (its tiled route:
``ops/gm_merge.py::tiled_merge_packed``, the column gather and merge2d
twins) against JAX's ``merge_batch_dispatch_packed`` with
``merge_spatial_tiles=4`` and ``pallas_merge=2`` (its Pallas column gather
and 2D merge in interpret mode), as tests/test_pallas_merge.py holds the
JAX tiled merge against its exact merge: separated quadrants (the exact
merge's clusters), boundary-crossing clusters (mass conserved, no fewer
clusters than the exact merge, every live lane inside n_merged), a tile
above the widest tile row (the untiled fallback), N < 256 and an out_cap
that 4 does not divide (untiled), and the interleaved lane order,
lane for lane.

The filter: replayed PHD steps (the narrowed dense configuration at K 128
and, with the feature-width switch, K 256), a CPHD step and a mixed step
with tiles on in both packages, on JAX's draws
(``tests/test_torch_step.py::replay_dataset``), under the step tests'
tolerances (rtol 1e-4 / atol 1e-5); each merge's tiled-or-untiled choice,
tile row width and candidate width are held equal to those JAX's merge ran
at (recorded from inside JAX's jitted step). One sharded step on two Gloo
ranks against JAX's sharded step on ``make_mesh(2)``.
"""

import collections
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phdslam_tpu.ops.pallas_merge as jpm
from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.ops.gm_merge import merge_batch_dispatch_packed
from phdslam_tpu.parallel import init_sharded_state as jax_init_sharded
from phdslam_tpu.parallel import make_mesh as jax_make_mesh
from phdslam_tpu.parallel import make_sharded_step_fn as jax_sharded_step
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters import phd
from phdslam_tpu_torch.filters.phd import TileRoute, merge_packed, phd_step
from phdslam_tpu_torch.kernels.merge import merge2d_reference
from phdslam_tpu_torch.ops import gm_merge as tgm
from phdslam_tpu_torch.parallel.sim import run_group
from phdslam_tpu_torch.types import state_from_jax, state_to_numpy
from test_torch_cphd import flush_subnormals  # noqa: F401 (fixture)
from test_torch_mixed import MIXED_STEP, jax_mixed_world
from test_torch_step import (dataset, jax_state_arrays, replay_dataset,
                             replay_noise)

SEP = 4.0
TILES = dict(merge_spatial_tiles=4, pallas_merge=2, pallas_detect=2,
             merge_r_par=1)
# cfg/dense.cfg narrowed to a CPU size where the live candidates pass 128
# after the first step: the candidate width switch picks 128 lanes
# (untiled) on step 0 and 256 (tiled) after
DENSE = dict(TILES, n_particles=6, max_features=128, max_measurements=48,
             detection_topk=8, merge_candidate_cap=384)
# the same at K = 256: the PHD update's feature-width switch runs
DENSE_K256 = dict(DENSE, n_particles=4, max_features=256)
# cfg/ackerman_cphd.cfg at its own widths (K 128, M 64, T 16, cap 512)
CPHD = dict(TILES, n_particles=4, max_cardinality=64)
# the mixed step of tests/test_torch_mixed.py over a world of 60
# landmarks, M 48, cap 256
MIXED = dict(MIXED_STEP, **TILES, n_particles=4, max_features=64,
             max_measurements=48, merge_candidate_cap=256)


# ----------------------------------------------------------------------------
# the merge alone
# ----------------------------------------------------------------------------

def sorted_planes(mean, cov, w, act):
    """[P, 7, N] planes of a weight-sorted live prefix (numpy), as the
    stage-2 top-cap selection emits them."""
    order = np.argsort(np.where(act, -w, 1.0), axis=1, kind="stable")
    take = functools.partial(np.take_along_axis, axis=1)
    w_s = np.where(take(act, order), take(w, order), 0.0)
    m = take(mean, order[..., None])
    c = take(cov.reshape(*cov.shape[:2], 4), order[..., None])
    return np.stack([w_s, (w_s > 0).astype(np.float32), m[..., 0],
                     m[..., 1], c[..., 0], c[..., 1], c[..., 3]],
                    axis=1).astype(np.float32)


def quadrant_case(P=4, N=320, seed=0, n_act=180, spread=1.0):
    """Candidates in four blobs far apart, one per quadrant about their
    centroid: no pair within min_separation straddles a tile boundary."""
    rng = np.random.default_rng(seed)
    centers = np.array([[-10.0, -10.0], [-10.0, 10.0], [10.0, -10.0],
                        [10.0, 10.0]])
    mean = centers[rng.integers(0, 4, (P, N))] \
        + rng.normal(0, spread, (P, N, 2))
    cov = np.broadcast_to(np.eye(2) * 0.3, (P, N, 2, 2))
    w = rng.uniform(0.05, 1, (P, N))
    act = np.broadcast_to(np.arange(N) < n_act, (P, N))
    return sorted_planes(mean, cov, w, act)


def cluster_case(P=4, N=320, seed=5, n_act=260, n_clusters=40):
    """Candidates around random cluster centres over one square, some
    straddling the quadrant boundaries, with random covariances."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-20, 20, (P, n_clusters, 2))
    pick = rng.integers(0, n_clusters, (P, N))
    mean = np.take_along_axis(centers, pick[..., None], axis=1) \
        + rng.normal(0, 0.7, (P, N, 2))
    a = rng.uniform(0.1, 0.6, (P, N))
    b = rng.uniform(0.1, 0.6, (P, N))
    r = rng.uniform(-0.05, 0.05, (P, N))
    cov = np.stack([np.stack([a, r], -1), np.stack([r, b], -1)], -2)
    w = rng.uniform(0.01, 1, (P, N))
    act = np.broadcast_to(np.arange(N) < n_act, (P, N))
    return sorted_planes(mean, cov, w, act)


def jax_merge(packed, tiles, out_cap):
    cfg = JaxSlamConfig(min_separation=SEP, distance_metric=0,
                        pallas_merge=2, merge_r_par=1,
                        merge_spatial_tiles=tiles)
    out = merge_batch_dispatch_packed(jnp.asarray(packed), 2, cfg, out_cap,
                                      sorted_prefix=True)
    return [np.asarray(x) for x in out]


def fixed_route(N):
    """A route on which the JAX version's merge width is N: a binding
    cap N, no switch."""
    return TileRoute(K=N, M=1, T=0, cap=N, births=True, switch=False)


def port_merge(packed, tiles, out_cap):
    cfg = SlamConfig(min_separation=SEP, distance_metric=0,
                     merge_spatial_tiles=tiles)
    route = phd.tile_route(cfg, 2, 1, 1) and fixed_route(packed.shape[-1])
    out = merge_packed(torch.from_numpy(packed), 2, cfg, out_cap, route)
    return [x.numpy() for x in out]


@contextlib.contextmanager
def tile_choices():
    """The merges' tiled-or-untiled choices inside the block, counted:
    "tiled", "untiled" (a tile above the widest tile row) and "narrow"
    (candidate width below 256), from a spy on the port's tile_width."""
    got = collections.Counter()
    real = phd.tile_width

    def spy(N, n_tile):
        ct = real(N, n_tile)
        got["tiled" if ct else "untiled" if N >= 256 else "narrow"] += 1
        return ct
    with mock.patch.object(phd, "tile_width", spy):
        yield got


def cluster_sets(mg):
    """Per particle, the live clusters (w, mean, cov) ordered by
    position."""
    om, oc, ow = mg[:3]
    out = []
    for p in range(ow.shape[0]):
        live = ow[p] > 0
        rows = np.stack([ow[p][live], om[p, live, 0], om[p, live, 1],
                         oc[p, live, 0, 0], oc[p, live, 0, 1],
                         oc[p, live, 1, 1]], axis=1)
        out.append(rows[np.lexsort((rows[:, 2], rows[:, 1]))])
    return out


def assert_lanes_equal(got, want):
    """The merge outputs lane for lane (the interleave included): means,
    covariances and weights to rtol / atol 1e-4, the live lanes, the
    live counts and the dropped counts exactly."""
    np.testing.assert_array_equal(got[2] > 0, want[2] > 0)
    for g, w, name in zip(got[:3], want[:3], ("mean", "cov", "w")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiled_merge_matches_jax_on_separated_quadrants(seed):
    """No pair straddles a boundary: the tiled merge gives the exact
    merge's clusters, lane for lane JAX's tiled output."""
    packed = quadrant_case(seed=seed)
    with tile_choices() as choices:
        got = port_merge(packed, 4, 128)
    assert choices == {"tiled": 1}
    exact = port_merge(packed, 0, 128)
    assert int(exact[4].sum()) == 0
    for g, e in zip(cluster_sets(got), cluster_sets(exact)):
        assert g.shape == e.shape
        np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal((got[2] > 0).sum(1), (exact[2] > 0).sum(1))
    np.testing.assert_array_equal(got[4], exact[4])
    assert_lanes_equal(got, jax_merge(packed, 4, 128))


def test_tiled_merge_conserves_mass_on_boundary_clusters():
    """Clusters straddling the boundaries: the mass is conserved, the
    tiled merge emits no fewer clusters than the exact one, every live
    lane lies inside n_merged, and the output is JAX's lane for lane."""
    packed = cluster_case()
    got = port_merge(packed, 4, 128)
    exact = port_merge(packed, 0, 128)
    w_in = float(packed[:, 0].astype(np.float64).sum())
    assert int(got[4].sum()) == 0 and int(exact[4].sum()) == 0
    np.testing.assert_allclose(got[2].sum(dtype=np.float64), w_in, rtol=1e-5)
    assert ((got[2] > 0).sum(1) >= (exact[2] > 0).sum(1)).all()
    assert ((got[2] > 0).sum(1) > (exact[2] > 0).sum(1)).any()
    live = got[2] > 0
    last = np.where(live.any(1), 128 - np.argmax(live[:, ::-1], 1), 0)
    assert (last <= got[3]).all()
    assert_lanes_equal(got, jax_merge(packed, 4, 128))


def test_tiled_lane_interleave_matches_jax():
    """Lane j 4 + t holds tile t's j-th cluster: with a small out_cap the
    tiles drop clusters (n_dropped summed over the tiles), and every lane
    is JAX's."""
    packed = cluster_case(seed=9, n_clusters=60)
    got = port_merge(packed, 4, 32)
    want = jax_merge(packed, 4, 32)
    assert int(got[4].min()) > 0
    assert_lanes_equal(got, want)
    np.testing.assert_array_equal(got[3], want[3])
    # tile t's clusters sit in lanes t, t + 4, ...: each tile row merged
    # on its own gives them in its emission order
    planes = torch.from_numpy(packed)
    rows = tgm.tile_rows(planes, tgm.tile_layout(planes), 128)
    w_rows = merge2d_reference(rows, SEP, 8)[:, 0].numpy().reshape(-1, 4, 8)
    for t in range(4):
        np.testing.assert_array_equal(got[2][:, t::4], w_rows[:, t])


def test_tiled_merge_falls_back_when_a_tile_overflows():
    """A quadrant of more than 384 live lanes (N 512): the exact untiled
    merge runs, bit for bit the port's untiled merge, and JAX's fallback
    gives the same."""
    rng = np.random.default_rng(3)
    P, N = 2, 512
    mean = np.concatenate([rng.normal(8, 1.5, (P, 420, 2)),
                           rng.normal(-8, 1.5, (P, N - 420, 2))], axis=1)
    cov = np.broadcast_to(np.eye(2) * 0.3, (P, N, 2, 2))
    packed = sorted_planes(mean, cov, rng.uniform(0.05, 1, (P, N)),
                           np.ones((P, N), bool))
    layout = tgm.tile_layout(torch.from_numpy(packed))
    assert int(layout[1].max()) > 384
    with tile_choices() as choices:
        got = port_merge(packed, 4, 128)
    assert choices == {"untiled": 1}
    for g, e in zip(got, port_merge(packed, 0, 128)):
        np.testing.assert_array_equal(g, e)
    assert_lanes_equal(got, jax_merge(packed, 4, 128))


@pytest.mark.parametrize("N,out_cap", [(128, 64), (320, 126)],
                         ids=["N below 256", "out_cap not a multiple of 4"])
def test_tiled_merge_stays_untiled(N, out_cap):
    """Candidate widths below 256 lanes and an out_cap that 4 does not
    divide run untiled, bit for bit the untiled merge, as in JAX."""
    packed = quadrant_case(N=N, n_act=min(N, 180))
    with tile_choices() as choices:
        got = port_merge(packed, 4, out_cap)
    assert "tiled" not in choices
    for g, e in zip(got, port_merge(packed, 0, out_cap)):
        np.testing.assert_array_equal(g, e)
    assert_lanes_equal(got, jax_merge(packed, 4, out_cap))


@pytest.mark.parametrize("over,routed", [
    (dict(), True), (dict(merge_spatial_tiles=2), False),
    (dict(pallas_merge=0), False), (dict(distance_metric=1), False)],
    ids=["tiles 4", "tiles 2", "no Pallas merge", "Hellinger"])
def test_tile_route_where_jax_tiles(over, routed):
    """Only merge_spatial_tiles 4 on the 2D Mahalanobis merge with the
    Pallas merge on tiles (JAX: other values, pallas_merge 0 and the
    Hellinger distance run untiled); the 4D map never does."""
    cfg = SlamConfig(**dict(dict(merge_spatial_tiles=4), **over))
    assert (phd.tile_route(cfg, 2, 128, 64) is not None) == routed
    assert phd.tile_route(cfg, 4, 128, 64) is None


@pytest.mark.parametrize("route,n_feat,n_live,width", [
    # Ackerman: cap 512, the candidate switch 128 / 256 / 384 / 512
    (dict(K=128, M=64, T=16, cap=512, births=True, switch=True), 0, 100,
     128),
    (dict(K=128, M=64, T=16, cap=512, births=True, switch=True), 0, 300,
     384),
    (dict(K=128, M=64, T=16, cap=512, births=True, switch=False), 0, 100,
     512),
    # the PHD feature switch at K' 128 caps the selection at
    # K' + M T + M = 272 lanes below cap 384; at K' 256 it does not
    (dict(K=256, M=16, T=8, cap=384, births=True, switch=True,
          from_cap=True, feat_widths=(128, 256)), 100, 300, 272),
    (dict(K=256, M=16, T=8, cap=384, births=True, switch=True,
          from_cap=True, feat_widths=(128, 256)), 200, 300, 384),
    # CPHD (no birth lanes), the switch over the selection's 272 lanes
    (dict(K=128, M=18, T=8, cap=512, births=False, switch=True), 0, 200,
     256),
    # a cap that does not bind at K': no sorted prefix, untiled
    (dict(K=256, M=1, T=0, cap=300, births=True, switch=True,
          from_cap=True, feat_widths=(128, 256)), 100, 50, 0),
])
def test_tile_route_width(route, n_feat, n_live, width):
    """The merge width the JAX version's switches pick, for the tiled-or-
    untiled choice (its ``_pre_merge_phase``, ``_batched_update`` and
    ``gather_merge_width_switched``)."""
    assert TileRoute(**route).width(n_feat, n_live) == width


def test_tile_width_follows_jax_switch():
    """The tile row width: the narrowest of 128, 256, 384 below N that
    holds the largest tile (JAX's ``_tiled_merge_packed`` switch)."""
    assert tgm.tile_width(128, 10) == 0
    assert tgm.tile_width(256, 128) == 128
    assert tgm.tile_width(256, 129) == 0
    assert tgm.tile_width(384, 200) == 256
    assert tgm.tile_width(384, 300) == 0
    assert tgm.tile_width(512, 300) == 384
    assert tgm.tile_width(512, 385) == 0
    assert [tgm.switched_width(tgm.switch_widths(1536), n)
            for n in (1, 384, 385, 1153)] == [384, 384, 768, 1536]


# ----------------------------------------------------------------------------
# the filter, on JAX's draws
# ----------------------------------------------------------------------------

@pytest.fixture
def merge_widths(monkeypatch):
    """Records, in step order, the (rows, lanes) of every 2D packed merge
    JAX's jitted steps run (a callback inside the taken branch of its
    switches) and the port's choice of each: (4 P, ct) tiled, else (P, N)
    at the JAX version's width N."""
    jax_rec, port_rec = [], []
    orig = jpm.gm_merge_pallas_batch_packed

    def spy(packed, *args, **kwargs):
        shape = packed.shape[0], packed.shape[-1]
        jax.debug.callback(lambda _: jax_rec.append(shape), packed[0, 0, 0])
        return orig(packed, *args, **kwargs)
    monkeypatch.setattr(jpm, "gm_merge_pallas_batch_packed", spy)
    route_width = TileRoute.width

    def width(self, n_feat, n_live):
        N = route_width(self, n_feat, n_live)
        port_rec.append(N)
        return N
    monkeypatch.setattr(TileRoute, "width", width)
    orig_tw = phd.tile_width

    def tile_width(N, n_tile):
        ct = orig_tw(N, n_tile)
        port_rec[-1] = (ct, N)
        return ct
    monkeypatch.setattr(phd, "tile_width", tile_width)
    return jax_rec, port_rec


def assert_same_choices(jax_rec, port_rec, P):
    """Each merge tiled where JAX's tiled, at its tile row width; an
    untiled merge at N >= 256 at JAX's width N; below, JAX's merge at most
    N lanes wide (its own width switch may narrow it further)."""
    assert len(jax_rec) == len(port_rec)
    for (rows, lanes), (ct, N) in zip(jax_rec, port_rec):
        if ct:
            assert (rows, lanes) == (4 * P, ct)
        elif N >= 256:
            assert (rows, lanes) == (P, N)
        else:
            assert rows == P and lanes <= N


@pytest.mark.parametrize("small", [DENSE, DENSE_K256], ids=["K128", "K256"])
def test_dense_steps_with_tiles_match_jax(merge_widths, small):
    """Replayed steps of the narrowed dense configuration with tiles on in
    both packages: states within the step tolerances, every merge's
    choice JAX's, the candidate width below 256 (untiled) on step 0 and
    tiled after."""
    n = 4 if small is DENSE else 3
    with tile_choices() as choices:
        replay_dataset("cfg/dense.cfg", "data/dense", small, n)
    assert_same_choices(*merge_widths, small["n_particles"])
    assert choices["narrow"] >= 1 and choices["tiled"] >= 1


def test_cphd_step_with_tiles_matches_jax(merge_widths,
                                          flush_subnormals):  # noqa: F811
    """Replayed CPHD steps (cfg/ackerman_cphd.cfg on data/ackerman) with
    tiles on: the untiled first steps, then a tiled one (subnormal
    detection terms flushed to zero in the port, as XLA's CPU does:
    tests/test_torch_cphd.py)."""
    with tile_choices() as choices:
        replay_dataset("cfg/ackerman_cphd.cfg", "data/ackerman", CPHD, 4)
    assert_same_choices(*merge_widths, CPHD["n_particles"])
    assert choices["tiled"] >= 1


def test_mixed_step_with_tiles_matches_jax(merge_widths,
                                          flush_subnormals):  # noqa: F811
    """Replayed mixed steps (the fast route, both maps' merges; the
    static one tiled) with tiles on (both maps' detects at min_fw 0 count
    their pdw > 0 lanes, so subnormals are flushed as in the CPHD
    test)."""
    dt, n_steps = 0.15, 3
    w = jax_mixed_world(60, 2, n_steps, dt, 3, MIXED["max_measurements"])
    jcfg, tcfg = JaxSlamConfig(**MIXED), SlamConfig(**MIXED)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_state_arrays(js, dynamic=True))
    with tile_choices() as choices:
        for n in range(n_steps):
            z, zm = w["z_all"][n], w["mask_all"][n]
            noise = replay_noise(js, jcfg)
            js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                            jnp.zeros(2, jnp.float32), jnp.float32(dt),
                            jnp.asarray(n > 0))
            ts, tout = phd_step(ts, torch.from_numpy(z), torch.from_numpy(zm),
                                (0.0, 0.0), dt, n > 0, tcfg, noise)
            got, want = state_to_numpy(ts), jax_state_arrays(js, dynamic=True)
            for name in ("pose", "log_weight", "map_weight", "map_mean",
                         "dyn_weight", "dyn_mean"):
                np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                           atol=1e-5, err_msg=f"{name} {n}")
            np.testing.assert_array_equal(got["resample_idx"],
                                          want["resample_idx"])
            assert int(tout.overflow) == int(jout.overflow)
    assert_same_choices(*merge_widths, MIXED["n_particles"])
    assert choices["tiled"] >= 1


def test_sharded_tiled_step_matches_jax(tmp_path):
    """Steps of the narrowed dense configuration on two Gloo ranks against
    JAX's sharded step on make_mesh(2), tiles on: the tiled-or-untiled
    choice reads the batch maxima over both ranks, as JAX's sharded step
    sees them. Each step starts from JAX's state before it."""
    over = dict(DENSE, n_particles=8)
    jcfg = jax_load_config("cfg/dense.cfg", over)
    z_all, mask_all, controls, sched = dataset(jcfg.max_measurements,
                                               "data/dense", jcfg.dt)
    mesh = jax_make_mesh(2)
    step = jax_sharded_step(jcfg, mesh, donate=False)
    js = jax_init_sharded(jcfg, mesh)
    rec, want = {}, []
    seq = {k: [] for k in ("z", "z_mask", "control", "dt", "do_predict",
                           "eps_pred", "u_resample")}
    control = np.zeros(2, np.float32)
    for n, plan in enumerate(sched[:3]):
        if plan.c_idx >= 0:
            control = controls[plan.c_idx]
        rec.update({f"s{n}_{k}": v
                    for k, v in jax_state_arrays(js).items()})
        z, zm = z_all[plan.z_idx], mask_all[plan.z_idx]
        noise = replay_noise(js, jcfg)
        js, out = step(js, jnp.asarray(z), jnp.asarray(zm),
                       jnp.asarray(control), jnp.float32(plan.dt),
                       jnp.asarray(plan.do_predict))
        for k, v in zip(seq, (z, zm, control, plan.dt, plan.do_predict,
                              noise.eps_pred.numpy(),
                              noise.u_resample.numpy())):
            seq[k].append(v)
        want.append((jax_state_arrays(js), jax.tree.map(np.asarray, out)))
    rec.update({k: np.asarray(v) for k, v in seq.items()})
    np.savez(tmp_path / "tiles.npz", **rec)
    res = run_group(2, {"kind": "replay", "cfg": "cfg/dense.cfg",
                        "overrides": over,
                        "npz": str(tmp_path / "tiles.npz")},
                    device="cpu", timeout_s=240)
    got = res[0]["arrays"]
    for n, (ws, wo) in enumerate(want):
        g = {k[len(f"step{n}_"):]: v for k, v in got.items()
             if k.startswith(f"step{n}_")}
        np.testing.assert_array_equal(g["resample_idx"], ws["resample_idx"])
        for k in ("pose", "log_weight"):
            np.testing.assert_allclose(g[k], ws[k], rtol=2e-4, atol=2e-5,
                                       err_msg=f"{k} step {n}")
        np.testing.assert_allclose(g["map_weight"], ws["map_weight"],
                                   rtol=2e-3, atol=1e-5,
                                   err_msg=f"map_weight step {n}")
        assert int(g["out_overflow"]) == int(wo.overflow)
    assert res[0]["tile_counts"]["tiled"] >= 1
