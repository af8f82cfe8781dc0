"""The fused routing step as one PyTorch program per batch.

Port of the JAX package's ``kernels/route_step.py`` dense program in its
kernel structure (``use_pallas=True`` there):

  1. mask ladder   — per-query rows of the stacked filter table and
     every ladder count are O(B) gathers (``_ladder``);
  2. blend terms   — feedback bias, LinUCB bandit estimates and the
     load penalty as one (B, Np) matrix (``_extras_matrix``);
  3. kNN           — the hand-written ``router_topk`` kernel (int8:
     ``router_topk_q8``) over the mask-fused cosine scores, reading
     each query's filter row straight from the uint8 table;
  4. re-rank       — the k candidates' blended scores, re-ranked;
  5. fallback      — rows whose kNN found nothing rank the blend under
     their first non-empty ladder rung.

Rank orders break ties toward the lowest index, as ``lax.top_k`` does
(``topk_stable`` and stable sorts; ``torch.topk`` promises no order).
Returns the eight outputs of the reference program.

The mega-catalog programs beside it:

  * ``route_step_sharded_body`` — the catalog split into equal column
    blocks over a ``launch.mesh.RoutingMesh``: per shard, the
    ``router_topk`` kernel's local top-R for primary rows, a local
    top-R of the blend for fallback rows and the per-lane payloads
    (global index, candidate blend score, cosine), then
    ``tree_merge_topk`` and the dense program's finalize.  Every score
    is summed in a fixed order (``_dot_cols``, ``_dot_lanes``, the
    kernel's index-order sums), so a column's bits do not depend on how
    many columns its block holds: the output equals the dense
    program's bit for bit, ties included.
  * ``route_step_ivf_body`` — the IVF-pruned search over a cell-packed
    catalog: the top-``nprobe`` centroid cells per query, one gather of
    their slots, the masked cosine top-k over them, the blend re-rank,
    and an exact full-catalog escape for rows the probe starves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.router_topk import (router_topk, router_topk_q8,
                                             topk_stable, tree_merge_topk)

NEG_INF = float("-inf")
CPU_BLOCK = 8192        # columns per pass of ``_dot_cols`` on the CPU


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8: ``q = clip(round(x / s), -127, 127)`` with
    ``s = max|row| / 127`` (all-zero rows take s = 1).  ``torch.round``
    rounds half to even, as ``jnp.round`` does.  127 is divided by as a
    tensor: on CUDA, PyTorch turns division by a Python number into
    multiplication by its reciprocal, which can differ from the
    reference's division in the last bit.  Returns (q int8 (R, D),
    s f32 (R, 1))."""
    x = x.float()
    amax = x.abs().amax(dim=1, keepdim=True)
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def unit_rows(x: torch.Tensor, weights: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """``x / (|x| + 1e-9)`` per row (``x * weights / (|x| + 1e-9)`` with
    per-axis ``weights``, the reference's weighted cosine), with the
    squared norm summed left to
    right in separate multiply and add passes and its square root taken
    in f64: the card and the CPU give the same bits.  (PyTorch's f32
    ``sqrt`` on the card is not correctly rounded; the f64 root rounded
    to f32 is, since 53 >= 2 * 24 + 2 bits.)  The int8 paths re-quantize
    these rows, and one ulp of difference can move a value across a
    rounding boundary and change a query's whole kNN set; a Thompson
    bandit's draws follow the kNN sets."""
    ss = x[:, 0] * x[:, 0]
    for d in range(1, x.shape[1]):
        ss = ss + x[:, d] * x[:, d]
    norm = torch.sqrt(ss.double()).float()
    num = x if weights is None else x * weights[None, :]
    return num / (norm[:, None] + 1e-9)


def _dot_cols(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, K) x (N, K) -> (B, N) = x @ y.T with every sum taken over K
    in index order, in separate multiply and add passes (no fused
    multiply-add).  A column's bits then depend on neither N nor the
    device: a matmul's library kernel, and with it its summation order,
    changes with the shape.  The CPU works through ``CPU_BLOCK``
    columns at a time, so the running sum stays in its cache."""
    K = x.shape[1]
    yt = y.T.contiguous()                               # (K, N)
    N = yt.shape[1]
    step = N if x.is_cuda else CPU_BLOCK
    parts = []
    for lo in range(0, N, step):
        blk = yt[:, lo:lo + step]
        acc = x[:, :1] * blk[:1]
        tmp = torch.empty_like(acc)
        for d in range(1, K):
            torch.mul(x[:, d:d + 1], blk[d:d + 1], out=tmp)
            acc.add_(tmp)
        parts.append(acc)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _dot_lanes(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, K) x (B, L, K) -> (B, L): each query's dot product with its
    own L gathered rows, summed over K in index order (separate
    multiply and add passes), whatever L is."""
    acc = x[:, None, 0] * rows[:, :, 0]
    for d in range(1, x.shape[1]):
        acc = acc + x[:, None, d] * rows[:, :, d]
    return acc


def _ladder(counts_table, ti, di, n_tt: int, n_dm: int):
    """Per-query mask rows and ladder counts: O(B) table gathers.
    Returns (ci combined-mask row, c_wide, has_primary, fi first
    non-empty fallback row, stage_f its fallback-ladder stage)."""
    n_combo = n_tt * n_dm
    ci = ti * n_dm + di
    c_wide = counts_table[ci]
    has_primary = c_wide > 0
    c_tt = counts_table[n_combo + ti]
    c_gen = counts_table[n_combo + n_tt]
    fi = torch.where(c_tt > 0, n_combo + ti,
                     torch.where(c_gen > 0, n_combo + n_tt,
                                 torch.full_like(ti, n_combo + n_tt + 1)))
    stage_f = torch.where(c_tt > 0, 2, torch.where(c_gen > 0, 3, 4))
    return ci, c_wide, has_primary, fi, stage_f.to(torch.int32)


def _extras_matrix(T, fb, theta, ainv_flat, lpen, params, B: int, Np: int):
    """(B, Np) extra blend terms (feedback / bandit / load), or None.
    ``fb``/``theta``/``lpen`` are None when their term is off; params
    (3,) f32 = [feedback_weight, adaptive_weight, alpha].  The LinUCB
    products are fixed-order sums (``_dot_cols``), so the sharded
    program's columns equal the dense program's."""
    extras = None
    if fb is not None:
        extras = params[0] * fb
    if theta is not None:
        ctx = torch.cat([T, T.new_ones((B, 1))], dim=1)
        mean = _dot_cols(ctx, theta)
        xx = (ctx[:, :, None] * ctx[:, None, :]).reshape(B, -1)
        var = _dot_cols(xx, ainv_flat)
        ucb = params[1] * (mean + params[2] * torch.sqrt(
            torch.clamp(var, min=0.0)))
        extras = ucb if extras is None else extras + ucb
    if lpen is not None:
        extras = (-lpen[None, :]).expand(B, Np) if extras is None \
            else extras - lpen[None, :]
    return extras


def _q8_cscore(w8, ws, e8e_rows, ese_rows):
    """Per-candidate int8 blend scores: the int dot of <= R gathered
    rows (exact as an fp32 sum of integer products below 2**24), one
    fp32 rescale — equal to gathering from the full int8 blend."""
    acc = (w8.float()[:, None, :] * e8e_rows.float()).sum(dim=-1)
    return acc * (ws * ese_rows)


def _q8_blend(w8, ws, e8e, ese):
    """(B, Np) int8 blend: the integer dot as an fp32 matmul (exact:
    every partial sum is an integer below 2**24, so no order changes
    it), one fp32 rescale."""
    return (w8.float() @ e8e.float().T) * (ws * ese[None, :])


def _lane_cos_q8(qn, e8n, esn, idx):
    """(B, L) cosines of the unit queries against the int8 unit rows
    ``idx`` (B, L), rescaled: fixed-order fp32 sums."""
    return _dot_lanes(qn, e8n[idx].float()) * esn[idx]


def _quant_operands(e2, e2s, M: int):
    """(e8n, esn) unit-row half for the kNN, (e8e, ese) raw-metric half
    for the blend — scales as (Np,) columns of ``e2s``."""
    return (e2[:, :M].contiguous(), e2s[:, 0].contiguous(),
            e2[:, M:], e2s[:, 1])


def route_step_body(e2, e2s, masks_table, counts_table, T, W, ti, di,
                    fb: Optional[torch.Tensor],
                    theta: Optional[torch.Tensor],
                    ainv_flat: Optional[torch.Tensor],
                    lpen: Optional[torch.Tensor], params, *, k: int, r: int,
                    n_tt: int, n_dm: int,
                    quant: bool = False) -> Dict[str, torch.Tensor]:
    """One routing step over a bucket-padded batch, all on one device.

    e2 (Np, 2M) catalog block ``[embn | emb]`` (int8 with ``quant``,
    per-row scales in e2s (Np, 2)); masks_table (rows, Np) uint8 stacked
    filter rows; counts_table (rows,) their populations; T/W (Qp, M)
    task vectors / scoring weights; ti/di (Qp,) filter row indices;
    fb (Qp, Np), theta (Np, Dc) + ainv_flat (Np, Dc*Dc), lpen (Np,)
    optional blend terms; params (3,) f32.  Returns (Qp,)/(Qp, R)
    tensors: ``model_idx``, ``score``, ``stage``, ``similarity``,
    ``cand_idx``, ``cand_score``, ``n_filtered``, ``n_candidates``.
    """
    Np, M2 = e2.shape
    M = M2 // 2
    B = T.shape[0]
    R = max(k, r)

    qn = unit_rows(T)
    ci, c_wide, has_primary, fi, stage_f = _ladder(
        counts_table, ti, di, n_tt, n_dm)
    extras = _extras_matrix(T, fb, theta, ainv_flat, lpen, params, B, Np)
    rows = ci.to(torch.int32).contiguous()
    if quant:
        e8n, esn, e8e, ese = _quant_operands(e2, e2s, M)
        q8, qs = quantize_rows(qn)
        w8, ws = quantize_rows(W)
        vals, idx = router_topk_q8(q8.contiguous(), e8n, qs[:, 0].contiguous(),
                                   esn, masks_table, rows, k)
    else:
        embn = e2[:, :M].contiguous()
        emb = e2[:, M:]
        vals, idx = router_topk(qn.contiguous(), embn, masks_table, rows, k)

    hp = has_primary[:, None]
    finite = vals > NEG_INF
    idx_safe = torch.where(finite, idx.long(), 0)
    if quant:
        cscore = _q8_cscore(w8, ws, e8e[idx_safe], ese[idx_safe])
    else:
        cscore = _dot_lanes(W, emb[idx_safe])
    if extras is not None:
        cscore = cscore + extras.gather(1, idx_safe)
    cscore = torch.where(finite, cscore, NEG_INF)
    cs, pos = torch.sort(cscore, dim=1, descending=True, stable=True)
    cidx = idx_safe.gather(1, pos)
    sim_p = vals.gather(1, pos[:, :1])[:, 0]
    if R > k:
        cs = torch.cat([cs, cs.new_full((B, R - k), NEG_INF)], dim=1)
        cidx = torch.cat([cidx, cidx.new_zeros((B, R - k))], dim=1)

    msel = masks_table[fi].bool()
    if quant:
        blend_f = _q8_blend(w8, ws, e8e, ese)
    else:
        blend_f = _dot_cols(W, emb)
    if extras is not None:
        blend_f = blend_f + extras
    zf = torch.where(hp | ~msel, NEG_INF, blend_f)
    fv, fidx = topk_stable(zf, R)
    fidx_safe = torch.where(fv > NEG_INF, fidx, 0)
    f0 = fidx_safe[:, :1]
    if quant:
        sim_f = _lane_cos_q8(qn, e8n, esn, f0)[:, 0]
    else:
        sim_f = _dot_lanes(qn, embn[f0])[:, 0]
    cand_score = torch.where(hp, cs, fv)
    cand_idx = torch.where(hp, cidx, fidx_safe)
    cand_idx = torch.where(torch.isfinite(cand_score), cand_idx,
                           -1).to(torch.int32)
    nf = torch.clamp(c_wide, max=k).to(torch.int32)
    zero = torch.zeros_like(nf)
    return {
        "model_idx": cand_idx[:, 0],
        "score": cand_score[:, 0],
        "stage": torch.where(has_primary, 0, stage_f).to(torch.int32),
        "similarity": torch.where(has_primary, sim_p, sim_f),
        "cand_idx": cand_idx,
        "cand_score": cand_score,
        "n_filtered": torch.where(has_primary, nf, zero),
        "n_candidates": torch.where(has_primary, nf,
                                    counts_table[fi].to(torch.int32)),
    }


# ----------------------------------------------------------------------
# IVF-pruned program: coarse centroid probe + packed-cell fine scan
# ----------------------------------------------------------------------

def route_step_ivf_body(e2, e2s, masks_table, counts_table, orig, cent, T,
                        W, ti, di, fb: Optional[torch.Tensor],
                        theta: Optional[torch.Tensor],
                        ainv_flat: Optional[torch.Tensor],
                        lpen: Optional[torch.Tensor], params, *, k: int,
                        r: int, n_tt: int, n_dm: int, nprobe: int, cap: int,
                        quant: bool = False
                        ) -> Tuple[Dict[str, torch.Tensor], int]:
    """IVF-pruned routing step over a CELL-PACKED catalog (the
    reference's ``route_step_ivf_jit``).

    ``ops._catalog_pack_ivf`` lays the catalog out in contiguous cells
    of ``cap`` slots (dead slots: ``orig < 0``, zero rows, all-False
    mask columns); every catalog-shaped operand (e2/e2s, mask columns,
    fb/theta/ainv_flat/lpen) arrives in PACKED order, while
    ``counts_table`` keeps the TRUE full-catalog counts.  ``orig``
    (Npk,) maps slots back to catalog rows; ``cent`` (C, M) holds the
    unit centroids.

    Per query: the top-``nprobe`` cells by centroid cosine (fixed-order
    sums, so the card and the CPU probe the same cells), ONE gather of
    their ``nprobe * cap`` slots, the masked cosine top-k over them and
    the blend re-rank at the k candidates.  Rows whose filter is empty,
    or whose probed cells miss every match, re-score the exact
    full-catalog blend under their rung (stage 1 for the latter); that
    branch runs only when some row needs it, which costs one host read
    per batch.  Returns (the eight outputs, the number of rows that
    took the escape).
    """
    B, M = T.shape
    C = cent.shape[0]
    Pn = min(nprobe, C)
    R = max(k, r)
    J = Pn * cap

    qn = unit_rows(T)
    ci, c_wide, has_primary, fi, stage_f = _ladder(
        counts_table, ti, di, n_tt, n_dm)
    if quant:
        e8n, esn, e8e, ese = _quant_operands(e2, e2s, M)
        q8, qs = quantize_rows(qn)
        w8, ws = quantize_rows(W)
    embn, emb = e2[:, :M], e2[:, M:]

    # ---- coarse: rank centroids, select cells, gather their slots
    _, cells = topk_stable(_dot_cols(qn, cent), Pn)        # (B, Pn)
    gidx = (cells[:, :, None] * cap + torch.arange(
        cap, device=cells.device)).reshape(B, J)
    valid = orig[gidx] >= 0
    mrow = masks_table[ci[:, None], gidx].bool()

    # ---- fine: mask-fused kNN over the gathered slots only
    if quant:
        sims = _q8_cscore(q8, qs, e8n[gidx], esn[gidx])
    else:
        sims = _dot_lanes(qn, embn[gidx])
    z1 = torch.where(mrow & valid, sims, NEG_INF)
    if J < k:
        z1 = torch.cat([z1, z1.new_full((B, k - J), NEG_INF)], dim=1)
        gidx = torch.cat([gidx, gidx.new_zeros((B, k - J))], dim=1)
    vals, pos = topk_stable(z1, k)
    finite = vals > NEG_INF
    pidx_safe = torch.where(finite, gidx.gather(1, pos), 0)
    has_knn = finite.any(dim=1)
    nf = finite.sum(dim=1).to(torch.int32)

    # ---- candidate re-rank at the k columns (gathered blend terms)
    if quant:
        cscore = _q8_cscore(w8, ws, e8e[pidx_safe], ese[pidx_safe])
    else:
        cscore = _dot_lanes(W, emb[pidx_safe])
    if fb is not None:
        cscore = cscore + params[0] * fb.gather(1, pidx_safe)
    if theta is not None:
        ctx = torch.cat([T, T.new_ones((B, 1))], dim=1)
        mean = _dot_lanes(ctx, theta[pidx_safe])
        xx = (ctx[:, :, None] * ctx[:, None, :]).reshape(B, -1)
        var = _dot_lanes(xx, ainv_flat[pidx_safe])
        cscore = cscore + params[1] * (mean + params[2] * torch.sqrt(
            torch.clamp(var, min=0.0)))
    if lpen is not None:
        cscore = cscore - lpen[pidx_safe]
    cscore = torch.where(finite, cscore, NEG_INF)
    cs, cpos = torch.sort(cscore, dim=1, descending=True, stable=True)
    cidx_pk = pidx_safe.gather(1, cpos)
    sim_p = vals.gather(1, cpos[:, :1])[:, 0]
    if R > k:
        cs = torch.cat([cs, cs.new_full((B, R - k), NEG_INF)], dim=1)
        cidx_pk = torch.cat([cidx_pk, cidx_pk.new_zeros((B, R - k))], dim=1)

    # ---- escape: count-0 ladder rows AND rows the probe starved
    fsel = torch.where(has_primary, ci, fi)
    fstage = torch.where(has_primary, 1, stage_f).to(torch.int32)
    need = ~has_knn
    # lint: ignore[torch-host-sync] -- the batch's one host read: the
    # escape's full-catalog pass runs only for rows that need it
    n_escape = int(need.sum())
    if n_escape:
        blend = _q8_blend(w8, ws, e8e, ese) if quant else _dot_cols(W, emb)
        extras = _extras_matrix(T, fb, theta, ainv_flat, lpen, params, B,
                                orig.shape[0])
        if extras is not None:
            blend = blend + extras
        keep = need[:, None] & masks_table[fsel].bool() & (orig >= 0)[None, :]
        fv, fpi = topk_stable(torch.where(keep, blend, NEG_INF), R)
        fpi = torch.where(fv > NEG_INF, fpi, 0)
        f0 = fpi[:, :1]
        if quant:
            fcos = _lane_cos_q8(qn, e8n, esn, f0)[:, 0]
        else:
            fcos = _dot_lanes(qn, embn[f0])[:, 0]
    else:
        fv = T.new_full((B, R), NEG_INF)
        fpi = cidx_pk.new_zeros((B, R))
        fcos = T.new_zeros(B)

    hk = has_knn[:, None]
    cand_score = torch.where(hk, cs, fv)
    cand_idx = torch.where(torch.isfinite(cand_score),
                           orig[torch.where(hk, cidx_pk, fpi)],
                           -1).to(torch.int32)
    zero = torch.zeros_like(nf)
    return {
        "model_idx": cand_idx[:, 0],
        "score": cand_score[:, 0],
        "stage": torch.where(has_knn, 0, fstage).to(torch.int32),
        "similarity": torch.where(has_knn, sim_p, fcos),
        "cand_idx": cand_idx,
        "cand_score": cand_score,
        "n_filtered": torch.where(has_knn, nf, zero),
        "n_candidates": torch.where(has_knn, nf,
                                    counts_table[fsel].to(torch.int32)),
    }, n_escape


# ----------------------------------------------------------------------
# sharded program: a loop over the mesh's shards + the merge tree
# ----------------------------------------------------------------------

@dataclass
class CatalogShard:
    """One shard's operands, all on its device: its column block of the
    catalog (``e2``/``e2s`` rows, the contiguous (rows, n_loc) uint8
    filter table block) and of the blend terms (None when off)."""
    offset: int                        # first global column
    e2: torch.Tensor
    e2s: torch.Tensor
    masks: torch.Tensor
    fb: Optional[torch.Tensor] = None  # (Qp, n_loc)
    theta: Optional[torch.Tensor] = None
    ainv_flat: Optional[torch.Tensor] = None
    lpen: Optional[torch.Tensor] = None


def _shard_carry(sh: CatalogShard, qn, T, W, q8, qs, w8, ws, rows, fi, hp,
                 params, *, R: int, quant: bool):
    """One shard's sorted (B, R) carry: (cosine or blend value, global
    index, candidate blend score, cosine), computed while the shard
    owns its columns.  Primary rows take the ``router_topk`` kernel's
    local top-R of the masked cosine, fallback rows the local top-R of
    their rung's blend."""
    dev = sh.e2.device
    B, M = T.shape
    n_loc = sh.e2.shape[0]
    to = (lambda x: x.to(dev)) if dev != T.device else (lambda x: x)
    qn, T, W, rows, fi, hp, params = map(to, (qn, T, W, rows, fi, hp,
                                              params))
    extras = _extras_matrix(T, sh.fb, sh.theta, sh.ainv_flat, sh.lpen,
                            params, B, n_loc)
    if quant:
        q8, qs, w8, ws = map(to, (q8, qs, w8, ws))
        e8n, esn, e8e, ese = _quant_operands(sh.e2, sh.e2s, M)
        kv, ki = router_topk_q8(q8.contiguous(), e8n, qs[:, 0].contiguous(),
                                esn, sh.masks, rows, R)
        blend = _q8_blend(w8, ws, e8e, ese)
    else:
        embn = sh.e2[:, :M].contiguous()
        emb = sh.e2[:, M:]
        kv, ki = router_topk(qn.contiguous(), embn, sh.masks, rows, R)
        blend = _dot_cols(W, emb)
    if extras is not None:
        blend = blend + extras
    hpc = hp[:, None]
    zf = torch.where(hpc | ~sh.masks[fi].bool(), NEG_INF, blend)
    fv, fidx = topk_stable(zf, R)
    vals = torch.where(hpc, kv, fv)
    finite = vals > NEG_INF
    pos = torch.where(finite, torch.where(hpc, ki.long(), fidx), 0)
    gidx = torch.where(finite, pos + sh.offset, -1)
    if quant:
        csc = _q8_cscore(w8, ws, e8e[pos], ese[pos])
        cos = _lane_cos_q8(qn, e8n, esn, pos)
    else:
        csc = _dot_lanes(W, emb[pos])
        cos = _dot_lanes(qn, embn[pos])
    if extras is not None:
        csc = csc + extras.gather(1, pos)
    return vals, gidx, csc, cos


def route_step_sharded_body(shards: Sequence[CatalogShard], counts_table, T,
                            W, ti, di, params, *, k: int, r: int, n_tt: int,
                            n_dm: int, quant: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """The routing step with the catalog split into column blocks, one
    per shard (``ops._catalog_pack_sharded``): the reference's
    ``route_step_sharded_jit`` as a loop over the shards.

    Per-query operands (T, W, ti, di, params) and ``counts_table`` live
    on the first shard's device, where the carries merge.  Each shard
    emits its sorted (B, R) carry (``_shard_carry``: one ``router_topk``
    launch); ``tree_merge_topk`` folds them, ties to the lowest global
    index at every level; the replicated finalize is the dense
    program's tail.  Same outputs as ``route_step_body``, bit for bit.
    """
    B = T.shape[0]
    R = max(k, r)
    qn = unit_rows(T)
    ci, c_wide, has_primary, fi, stage_f = _ladder(
        counts_table, ti, di, n_tt, n_dm)
    q8 = qs = w8 = ws = None
    if quant:
        q8, qs = quantize_rows(qn)
        w8, ws = quantize_rows(W)
    rows = ci.to(torch.int32).contiguous()
    carries = [_shard_carry(sh, qn, T, W, q8, qs, w8, ws, rows, fi,
                            has_primary, params, R=R, quant=quant)
               for sh in shards]
    home = T.device
    vals, idx, csc, cos = (torch.stack([c[j].to(home) for c in carries])
                           for j in range(4))
    vals, (idx, csc, cos) = tree_merge_topk(vals, (idx, csc, cos), index=0)

    # ---- replicated finalize: the dense program's tail
    hp = has_primary[:, None]
    finite = vals > NEG_INF
    idx_safe = torch.where(finite, idx, 0)
    kmask = torch.arange(R, device=home)[None, :] < k
    cscore = torch.where(finite & kmask, csc, NEG_INF)
    cs, pos = torch.sort(cscore, dim=1, descending=True, stable=True)
    cidx = idx_safe.gather(1, pos)
    sim_p = vals.gather(1, pos[:, :1])[:, 0]
    cand_score = torch.where(hp, cs, vals)
    cand_idx = torch.where(hp, cidx, idx_safe)
    cand_idx = torch.where(torch.isfinite(cand_score), cand_idx,
                           -1).to(torch.int32)
    nf = torch.clamp(c_wide, max=k).to(torch.int32)
    zero = torch.zeros_like(nf)
    return {
        "model_idx": cand_idx[:, 0],
        "score": cand_score[:, 0],
        "stage": torch.where(has_primary, 0, stage_f).to(torch.int32),
        "similarity": torch.where(has_primary, sim_p, cos[:, 0]),
        "cand_idx": cand_idx,
        "cand_score": cand_score,
        "n_filtered": torch.where(has_primary, nf, zero),
        "n_candidates": torch.where(has_primary, nf,
                                    counts_table[fi].to(torch.int32)),
    }
