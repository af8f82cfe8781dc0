"""The mega-catalog routing programs of the port against the JAX
package: the IVF index (bit-equal), the cross-shard top-k merge
(bit-equal), the IVF-pruned route step and the catalog-sharded one.

The port runs on the CPU (``device="cpu"``, the kernels' plain
versions), the reference as its own tests run it (four host devices,
``tests/conftest.py``).  Decisions compare as in
``tests/test_torch_route_step.py``: stages and counts exactly, scores
within 1e-5, indices tie-aware.  The port's sharded program must equal
its dense program bit for bit on all eight outputs, ties included.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mres import build_ivf as jbuild_ivf
from repro.data.workload import make_workload
from repro.core.orchestrator import OptiRoute as JOptiRoute
from repro.core import analyzer as JA
from repro.kernels import ops as K
from repro.kernels import ref as R
from repro.kernels.router_topk import merge_topk as jmerge
from repro.kernels.router_topk import tree_merge_topk as jtree
from repro.launch.mesh import make_routing_mesh as jmesh
from repro_torch.core import analyzer as TA
from repro_torch.core.mres import build_ivf, default_n_cells
from repro_torch.core.orchestrator import OptiRoute as TOptiRoute
from repro_torch.kernels import ops as P
from repro_torch.kernels.router_topk import merge_topk, tree_merge_topk
from repro_torch.launch.mesh import make_routing_mesh
from repro_torch.obs import Tracer
from tests.test_mega_catalog import _knn_problem
from tests.test_route_step import _random_problem, _ref_kwargs
from tests.test_torch_route_step import _problem, assert_route_match
from tests.test_torch_router_paths import (assert_decisions_match,
                                           catalog_spec, catalogs, engines,
                                           queries)


def _cpu_mesh(n=4):
    return make_routing_mesh(n, device="cpu")


# ----------------------------------------------------------------------
# the IVF index
# ----------------------------------------------------------------------

@pytest.mark.parametrize("N,C,seed,clustered", [
    (64, 8, 0, False), (300, 12, 17, False), (1024, 32, 21, True),
    (4000, default_n_cells(4000), 3, True)])
def test_build_ivf_bit_equal_to_reference(N, C, seed, clustered):
    emb = _knn_problem(1, N, seed, clustered=clustered)[0]
    got, want = build_ivf(emb, C, seed=seed), jbuild_ivf(emb, C, seed=seed)
    assert got.n_cells == want.n_cells
    assert got.centroids.dtype == want.centroids.dtype
    np.testing.assert_array_equal(got.centroids, want.centroids)
    np.testing.assert_array_equal(got.cell_of, want.cell_of)


def test_mres_ivf_index_caching():
    """Cached until a registration dirties the store; a different
    n_cells rebuilds."""
    from repro_torch.core.mres import MRES, ModelEntry
    spec = catalog_spec(41, seed=5)
    mres = MRES()
    mres.register_many([ModelEntry(**e) for e in spec[:40]])
    a = mres.ivf_index()
    assert a is mres.ivf_index() and a.n_cells == default_n_cells(40)
    b = mres.ivf_index(n_cells=4)
    assert b is not a and b.n_cells == 4
    mres.register(ModelEntry(**spec[40]))
    c = mres.ivf_index()
    assert c is not b and c.cell_of.shape == (41,)
    jm, _ = catalogs(spec)
    np.testing.assert_array_equal(c.cell_of, jm.ivf_index().cell_of)


# ----------------------------------------------------------------------
# the cross-shard merge
# ----------------------------------------------------------------------

def _carries(S, seed, Q=4, k=5):
    rng = np.random.default_rng(seed)
    vals = -np.sort(-rng.integers(0, 9, (S, Q, k)).astype(np.float32),
                    axis=2)
    idx = np.arange(S * Q * k, dtype=np.int32).reshape(S, Q, k)
    side = rng.random((S, Q, k)).astype(np.float32)
    return vals, idx, side


@pytest.mark.parametrize("S", [2, 3, 4, 7])
def test_tree_merge_topk_bit_equal_to_reference(S):
    """Heavily tied carries (values 0-8): values and both payloads equal
    the reference's lane for lane."""
    vals, idx, side = _carries(S, seed=3 + S)
    mv, (mi, ms) = tree_merge_topk(torch.from_numpy(vals), (
        torch.from_numpy(idx), torch.from_numpy(side)))
    jv, (ji, js) = jtree(jnp.asarray(vals), (jnp.asarray(idx),
                                            jnp.asarray(side)))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ms.numpy(), np.asarray(js))


@pytest.mark.parametrize("k", [5, 8])
def test_merge_topk_bit_equal_to_reference(k):
    """Two tied carries, k padded to a power of two or not."""
    vals, idx, _ = _carries(2, seed=k, Q=6, k=k)
    got = merge_topk(*(torch.from_numpy(a) for a in (vals[0], idx[0],
                                                     vals[1], idx[1])))
    want = jmerge(*(jnp.asarray(a) for a in (vals[0], idx[0], vals[1],
                                             idx[1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("S", [2, 3, 4, 7])
def test_tree_merge_topk_by_index_is_a_stable_top_k(S):
    """With ``index``, the merge equals a top-k of the concatenated
    carries with ties to the lowest global index (carries of ascending
    index ranges, each in that order, as the shards emit them)."""
    vals, _, side = _carries(S, seed=11 + S)
    Q, k = vals.shape[1:]
    idx = np.broadcast_to(np.arange(S * k, dtype=np.int64).reshape(S, 1, k),
                          vals.shape).copy()
    mv, (mi, ms) = tree_merge_topk(torch.from_numpy(vals), (
        torch.from_numpy(idx), torch.from_numpy(side)), index=0)
    flat = vals.transpose(1, 0, 2).reshape(Q, S * k)
    order = np.argsort(-flat, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(mv.numpy(),
                                  np.take_along_axis(flat, order, 1))
    np.testing.assert_array_equal(mi.numpy(), order)
    flats = side.transpose(1, 0, 2).reshape(Q, S * k)
    np.testing.assert_array_equal(ms.numpy(),
                                  np.take_along_axis(flats, order, 1))


def test_n_bucket_sharded_equals_reference():
    for n in (1, 5, 96, 127, 128, 129, 512, 513, 2048, 100_000):
        for ndev in (1, 2, 3, 4, 8):
            assert P.n_bucket_sharded(n, ndev) == K.n_bucket_sharded(n, ndev)
    assert P.n_bucket_sharded(100_000, 4) == 100_352


# ----------------------------------------------------------------------
# the IVF program
# ----------------------------------------------------------------------

def _ivf_problem(quant, blend, sparse, seed):
    B, N, C = 19, 257, 16
    args, kw = _problem(B, N, seed, fb=blend, ad=blend, load=blend,
                        sparse=sparse)
    return args, kw, jbuild_ivf(args[0], C), C


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("blend", [False, True], ids=["plain", "blend"])
@pytest.mark.parametrize("nprobe", [1, 2, 6, "C"])
def test_ivf_route_step_matches_reference(quant, blend, nprobe):
    """Against the reference's IVF program and its oracle
    (``ref.route_step_ivf``), on filters sparse enough that both escape
    hatches fire: count-0 ladder rows and rows the probe starves."""
    args, kw, ivf, C = _ivf_problem(quant, blend, True, seed=7)
    npb = C if nprobe == "C" else nprobe
    tr = Tracer()
    got = P.route_step(*args, k=6, r=6, ivf=ivf.as_tuple(), nprobe=npb,
                       quant=quant, device="cpu", tracer=tr, **kw)
    want = K.route_step(*args, k=6, r=6, ivf=ivf.as_tuple(), nprobe=npb,
                        quant=quant, **kw)
    assert_route_match(got, want)
    oracle = R.route_step_ivf(*(jnp.asarray(a) for a in args), 6, 6,
                              jnp.asarray(ivf.centroids),
                              jnp.asarray(ivf.cell_of), npb, quant=quant,
                              **_ref_kwargs(kw))
    assert_route_match(got, oracle)
    (sp,) = [s for s in tr.spans() if s.name == "route_step"]
    assert sp.attrs["path"] == "ivf" and sp.attrs["shards"] == 1
    escaped = int((got["stage"] > 0).sum())
    assert sp.attrs["escape_rows"] == escaped > 0
    if npb == 1:                    # the probe starves some filtered rows
        assert (got["stage"] == 1).any()


def test_ivf_exhaustive_nprobe_matches_dense():
    """nprobe = C scans every cell: the dense program's decisions."""
    args, kw = _random_problem(6, 300, seed=17)
    ivf = build_ivf(args[0], 12)
    dense = P.route_step(*args, k=5, r=5, device="cpu", **kw)
    got = P.route_step(*args, k=5, r=5, ivf=ivf.as_tuple(), nprobe=12,
                       device="cpu", **kw)
    for key in ("model_idx", "stage", "cand_idx", "n_filtered",
                "n_candidates"):
        np.testing.assert_array_equal(got[key], dense[key], err_msg=key)
    for key in ("score", "similarity", "cand_score"):
        np.testing.assert_allclose(got[key], dense[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


# ----------------------------------------------------------------------
# the sharded program
# ----------------------------------------------------------------------

SHARD_CASES = [
    (1, 5, 3, (True, True, True)),       # catalog smaller than the mesh
    (9, 130, 8, (True, False, True)),
    (16, 515, 4, (False, True, False)),  # past one sharded bucket
    (33, 96, 2, (False, False, False)),
]


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    for key in sorted(want):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,N,k,flags", SHARD_CASES)
def test_sharded_route_step_bit_identical_to_dense(B, N, k, flags, quant):
    args, kw = _random_problem(B, N, seed=B + N, with_fb=flags[0],
                               with_ad=flags[1], with_load=flags[2])
    r = min(max(5, k), N)
    tr = Tracer()
    want = P.route_step(*args, k=k, r=r, quant=quant, device="cpu", **kw)
    got = P.route_step(*args, k=k, r=r, quant=quant, mesh=_cpu_mesh(),
                       device="cpu", tracer=tr, **kw)
    _assert_bit_equal(got, want)
    (sp,) = [s for s in tr.spans() if s.name == "route_step"]
    assert (sp.attrs["path"], sp.attrs["shards"], sp.attrs["n_bucket"]) == \
        ("sharded", 4, P.n_bucket_sharded(N, 4))


def _tied_problem(seed):
    """Every catalog row duplicated into another shard (rows, filters
    and blend terms alike), queries aimed at the duplicates, sparse
    filters: equal cosines and equal blends in the kNN and in every
    fallback rung."""
    B, half = 24, 300
    args, kw = _problem(B, half, seed, fb=True, ad=True, load=True,
                        sparse=True)
    emb, tt, dm, gmask, T, W, ti, di = args
    dup = lambda a, ax: np.concatenate([a, a], axis=ax)
    emb, tt, dm, gmask = dup(emb, 0), dup(tt, 1), dup(dm, 1), dup(gmask, 0)
    T[: B // 2] = emb[np.random.default_rng(seed).integers(0, half, B // 2)]
    kw = dict(kw, fb=dup(kw["fb"], 1), theta=dup(kw["theta"], 0),
              ainv=dup(kw["ainv"], 0), lpen=dup(kw["lpen"], 0))
    return (emb, tt, dm, gmask, T, W, ti, di), kw


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_sharded_route_step_bit_identical_with_ties(quant, n_shards):
    args, kw = _tied_problem(seed=5)
    want = P.route_step(*args, k=8, r=8, quant=quant, device="cpu", **kw)
    got = P.route_step(*args, k=8, r=8, quant=quant,
                       mesh=_cpu_mesh(n_shards), device="cpu", **kw)
    _assert_bit_equal(got, want)
    cs = want["cand_score"]
    ties = np.isfinite(cs[:, 1:]) & (cs[:, 1:] == cs[:, :-1])
    assert ties.any() and (want["stage"] > 0).any() and \
        (want["stage"] == 0).any()


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,N,k,flags", SHARD_CASES)
def test_sharded_route_step_matches_reference_sharded(B, N, k, flags, quant):
    """Against the reference's ``shard_map`` program on its 4-device
    routing mesh."""
    if jax.device_count() < 4:
        pytest.fail("tests/conftest.py gives the reference 4 host devices")
    args, kw = _random_problem(B, N, seed=B + N, with_fb=flags[0],
                               with_ad=flags[1], with_load=flags[2])
    r = min(max(5, k), N)
    got = P.route_step(*args, k=k, r=r, quant=quant, mesh=_cpu_mesh(),
                       device="cpu", **kw)
    want = K.route_step(*args, k=k, r=r, quant=quant, mesh=jmesh(4), **kw)
    assert_route_match(got, want)


def test_route_step_refuses_mesh_with_ivf():
    args, kw = _random_problem(3, 40, seed=1)
    ivf = build_ivf(args[0], 4)
    with pytest.raises(ValueError, match="not composed"):
        P.route_step(*args, k=3, r=5, mesh=_cpu_mesh(), ivf=ivf.as_tuple(),
                     device="cpu")


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

def _set_mode(je, te, mode, quant=False):
    """Both packages' engines to the sharded (4 shards) or the IVF
    (nprobe 3, no size gate) program, as attributes."""
    for eng in (je, te):
        eng.quantize = quant
    if mode == "sharded":
        je.mesh, te.mesh = jmesh(4), _cpu_mesh()
    else:
        for eng in (je, te):
            eng.ivf, eng.ivf_min_n, eng.nprobe = True, 1, 3


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("mode", ["sharded", "ivf"])
def test_engine_route_many_batch_matches_reference(mode, quant):
    je, te = engines(96, seed=13)
    _set_mode(je, te, mode, quant)
    te.tracer = Tracer()
    (jp, js), (tp, ts) = queries(21, seed=13)
    want = je.route_many_batch(jp, js).decisions()
    got = te.route_many_batch(tp, ts).decisions()
    assert_decisions_match(want, got)
    (sp,) = [s for s in te.tracer.spans() if s.name == "route_step"]
    assert sp.attrs["path"] == mode


@pytest.mark.parametrize("mode", ["sharded", "ivf"])
def test_engine_route_all_matches_reference(mode):
    """``route_all`` with a fused-capable analyzer leaves the fused
    analyze->route program for both modes (analyzer, then
    ``route_many_batch``), in both packages."""
    jm, tm = catalogs(catalog_spec(64, seed=2))
    cfg = dict(vocab_size=512, d_model=32, n_layers=2, n_heads=2, d_ff=64,
               max_len=24)
    ja = JA.TaskAnalyzer(JA.AnalyzerConfig(**cfg), seed=3)
    ta = TA.TaskAnalyzer(TA.AnalyzerConfig(**cfg), device="cpu",
                         state=TA.params_from_jax(
                             jax.tree_util.tree_map(np.asarray, ja.params)))
    jr = JOptiRoute(jm, ja, use_kernel=True)
    jr.engine._kernel_min_n = 1
    tr = TOptiRoute(tm, ta, tracer=Tracer(), device="cpu")
    for r in (jr, tr):
        r.engine.confidence_threshold = 0.0
    _set_mode(jr.engine, tr.engine, mode)
    assert not tr._fully_fused_ok() and not jr._fully_fused_ok()
    texts = [w.text for w in make_workload(13, seed=9)]
    ja_ = jr.route_all(texts, "balanced")
    ta_ = tr.route_all(texts, "balanced")
    for a, b in zip(ja_, ta_):
        assert (a.sig.task_type, a.sig.domain) == (b.sig.task_type,
                                                   b.sig.domain)
    assert_decisions_match([a.decision for a in ja_],
                           [b.decision for b in ta_])
    paths = {s.attrs["path"] for s in tr.tracer.spans()
             if s.name == "route_step"}
    assert paths == {mode}


def test_engine_ivf_gate_shows_in_the_span_path():
    """Below ``ivf_min_n`` the dense program serves (and route_tokens
    stays allowed); at it, the IVF program."""
    _, te = engines(64, seed=19, fb=False, ad=False, load=False)
    te.ivf, te.tracer = True, Tracer()
    (_, _), (tp, ts) = queries(6, seed=19)
    dense = te.route_many_batch(tp, ts)            # 64 < 4096
    te.ivf_min_n = 64
    ivf = te.route_many_batch(tp, ts)
    paths = [s.attrs["path"] for s in te.tracer.spans()
             if s.name == "route_step"]
    assert paths == ["dense", "ivf"]
    np.testing.assert_array_equal(ivf.model_idx, dense.model_idx)
    np.testing.assert_array_equal(ivf.stage, dense.stage)


@pytest.mark.parametrize("mode", ["sharded", "ivf"])
def test_route_tokens_batch_refuses_both_modes(mode):
    _, te = engines(32, seed=4, fb=False, ad=False, load=False)
    te.mesh, te.ivf, te.ivf_min_n = (_cpu_mesh(), False, 4096) \
        if mode == "sharded" else (None, True, 1)
    toks = np.zeros((2, 8), np.int32)
    with pytest.raises(ValueError, match="mesh-sharded" if mode == "sharded"
                       else "IVF"):
        te.route_tokens_batch(None, None, toks, "balanced")


def test_catalog_cache_holds_the_variants_capped():
    """fp32, int8, IVF and sharded packs of one snapshot all stay live
    (four entries, distinct keys); a fifth variant evicts the oldest."""
    P.reset_catalog_cache()
    _, te = engines(48, seed=7, fb=False, ad=False, load=False)
    (_, _), (tp, ts) = queries(4, seed=7)
    models = []
    for quant, mesh, ivf in ((False, None, False), (True, None, False),
                             (False, None, True), (False, _cpu_mesh(), False)):
        te.quantize, te.mesh, te.ivf, te.ivf_min_n = quant, mesh, ivf, 1
        models.append(te.route_many_batch(tp, ts).model_idx)
    info = P.catalog_cache_info()
    assert info["entries"] == P._CATALOG_CACHE_MAX == 4
    assert len(set(info["keys"])) == 4
    assert {key[1] for key in info["keys"]} >= {"ivf", "sharded"}
    te.quantize, te.mesh, te.ivf = True, None, True
    te.route_many_batch(tp, ts)
    assert P.catalog_cache_info()["entries"] == 4
    te.quantize, te.ivf = False, False
    np.testing.assert_array_equal(te.route_many_batch(tp, ts).model_idx,
                                  models[0])
    P.reset_catalog_cache()
    gc.collect()
