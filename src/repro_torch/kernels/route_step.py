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
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.router_topk import (router_topk, router_topk_q8,
                                             topk_stable)

NEG_INF = float("-inf")


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


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """``x / (|x| + 1e-9)`` per row, with the squared norm summed left to
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
    return x / (norm[:, None] + 1e-9)


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
    products stay ``torch.matmul``, as the reference leaves them to
    XLA."""
    extras = None
    if fb is not None:
        extras = params[0] * fb
    if theta is not None:
        ctx = torch.cat([T, T.new_ones((B, 1))], dim=1)
        mean = ctx @ theta.T
        xx = (ctx[:, :, None] * ctx[:, None, :]).reshape(B, -1)
        var = xx @ ainv_flat.T
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
        cscore = (W[:, None, :] * emb[idx_safe]).sum(dim=-1)
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
        blend_f = (w8.float() @ e8e.float().T) * (ws * ese[None, :])
    else:
        blend_f = W @ emb.T
    if extras is not None:
        blend_f = blend_f + extras
    zf = torch.where(hp | ~msel, NEG_INF, blend_f)
    fv, fidx = topk_stable(zf, R)
    fidx_safe = torch.where(fv > NEG_INF, fidx, 0)
    f0 = fidx_safe[:, 0]
    if quant:
        sim_f = (qn * e8n[f0].float()).sum(dim=1) * esn[f0]
    else:
        sim_f = (qn * embn[f0]).sum(dim=1)
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
