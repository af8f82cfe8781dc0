"""The port's routing step against the JAX package's, on all eight
outputs: ``repro_torch.kernels.ops.route_step(device="cpu")`` (the
plain kernel versions) against ``repro.kernels.ops.route_step(...,
use_pallas=True)`` (the interpret-mode Pallas kNN), fp32 and int8, each
blend term on and off, with filters heavy enough that every fallback
rung fires.  Scores within 1e-5; indices compared tie-aware (they may
differ only inside a run of candidates whose reference scores tie within
1e-5); counts and stages exactly."""
import numpy as np
import pytest

from repro.kernels import ops as K
from repro_torch.kernels import ops as P

TOL = 1e-5
M = 8
NT, ND = 11, 6


def _problem(B, N, seed, *, fb, ad, load, sparse):
    rng = np.random.default_rng(seed)
    emb = rng.random((N, M)).astype(np.float32)
    p_tt, p_dm = (0.05, 0.1) if sparse else (0.4, 0.5)
    tt = np.vstack([rng.random((NT, N)) < p_tt, np.ones((1, N), bool)])
    dm = np.vstack([rng.random((ND, N)) < p_dm, np.ones((1, N), bool)])
    if sparse:
        tt[:3] = False                  # empty task-type rows
    gmask = rng.random(N) < (0.0 if sparse else 0.2)
    T = rng.random((B, M)).astype(np.float32)
    W = rng.random((B, M)).astype(np.float32)
    ti = rng.integers(0, NT + 1, B).astype(np.int32)
    di = rng.integers(0, ND + 1, B).astype(np.int32)
    kw = {}
    if fb:
        kw.update(fb=(rng.random((B, N)) - 0.5).astype(np.float32),
                  fb_weight=0.5)
    if ad:
        Dc = M + 1
        L = rng.standard_normal((N, Dc, Dc)).astype(np.float32) * 0.05
        kw.update(theta=rng.standard_normal((N, Dc)).astype(np.float32) * 0.1,
                  ainv=np.einsum("nde,nfe->ndf", L, L)
                  + 0.5 * np.eye(Dc, dtype=np.float32),
                  alpha=0.8, ad_weight=0.6)
    if load:
        kw["lpen"] = (rng.random(N) * 0.3).astype(np.float32)
    return (emb, tt, dm, gmask, T, W, ti, di), kw


def assert_ranked_match(got_idx, got_score, want_idx, want_score, tol=TOL):
    """Ranked candidate lists: same finite slots, scores within ``tol``,
    an index may differ only where the reference ranks a candidate with
    that index at a score within ``tol`` (a tie)."""
    fin = np.isfinite(want_score)
    np.testing.assert_array_equal(np.isfinite(got_score), fin)
    np.testing.assert_allclose(got_score[fin], want_score[fin], rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(got_idx[~fin], want_idx[~fin])
    for b, j in zip(*np.nonzero(fin & (got_idx != want_idx))):
        alt = np.nonzero(want_idx[b] == got_idx[b, j])[0]
        assert alt.size and abs(want_score[b, alt[0]]
                                - want_score[b, j]) <= tol, (b, j)


def assert_route_match(got, want):
    for key in ("stage", "n_filtered", "n_candidates"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    want = {k2: np.asarray(v) for k2, v in want.items()}
    assert_ranked_match(got["cand_idx"], got["cand_score"],
                        want["cand_idx"], want["cand_score"])
    np.testing.assert_array_equal(got["model_idx"], got["cand_idx"][:, 0])
    np.testing.assert_allclose(got["score"], want["score"], atol=TOL)
    same = got["model_idx"] == want["model_idx"]
    np.testing.assert_allclose(got["similarity"][same],
                               want["similarity"][same], atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,fb,ad,load,sparse", [
    (1, False, False, False, False),
    (5, True, False, False, True),
    (8, False, True, False, False),
    (13, False, False, True, True),
    (13, True, True, True, False),
    (5, True, True, True, True),
])
def test_route_step_matches_jax_kernel_structure(quant, B, fb, ad, load,
                                                 sparse):
    N = 200
    args, kw = _problem(B, N, seed=B * 7 + 3 * fb + 5 * ad + 11 * load
                        + 13 * sparse, fb=fb, ad=ad, load=load,
                        sparse=sparse)
    k, r = 8, 8
    got = P.route_step(*args, k=k, r=r, quant=quant, device="cpu", **kw)
    want = K.route_step(*args, k=k, r=r, quant=quant, use_pallas=True, **kw)
    assert set(got) == set(want)
    assert_route_match(got, want)


def test_route_step_fallback_rungs_all_fire():
    """The sparse filters reach every ladder stage in one batch."""
    args, kw = _problem(64, 200, seed=4, fb=False, ad=False, load=False,
                        sparse=True)
    got = P.route_step(*args, k=4, r=5, device="cpu", **kw)
    want = K.route_step(*args, k=4, r=5, use_pallas=True, **kw)
    assert_route_match(got, want)
    assert {0, 2, 4} <= set(got["stage"].tolist())


def test_route_step_r_wider_than_k():
    args, kw = _problem(9, 150, seed=8, fb=True, ad=False, load=True,
                        sparse=True)
    got = P.route_step(*args, k=3, r=6, device="cpu", **kw)
    want = K.route_step(*args, k=3, r=6, use_pallas=True, **kw)
    assert got["cand_idx"].shape == (9, 6)
    assert_route_match(got, want)


def test_dispatch_counter_and_weak_catalog_cache():
    """One dispatch count per routing step; the device copy of a
    catalog lives only as long as the catalog array it was packed from."""
    import gc
    args, kw = _problem(3, 40, seed=1, fb=False, ad=False, load=False,
                        sparse=False)
    emb = args[0].copy()
    P.reset_route_step_stats()
    P.reset_catalog_cache()
    P.route_step(emb, *args[1:], k=4, r=5, device="cpu")
    P.route_step(emb, *args[1:], k=4, r=5, device="cpu")
    assert P.route_step_stats()["route_step_dispatches"] == 2
    assert P.catalog_cache_info()["entries"] == 1      # packed once
    del emb
    gc.collect()
    assert P.catalog_cache_info()["entries"] == 0
