"""Masked-cosine top-k over the routing catalog: wrappers of the CUDA
kernel in ``csrc/router_topk.cu`` and their plain PyTorch versions.

``router_topk`` replaces the Pallas ``router_topk_pallas`` and
``router_topk_q8`` replaces ``router_topk_q8_pallas`` (the JAX
package's ``kernels/router_topk.py``).  Same contract: per query, the
k best rows by score (fp32: ``q . e``; int8: ``float(int32 dot) *
(qscale * escale)``), ``+ bias`` on rows the mask lets through, rows
below ``min_score`` dropped, ties toward the lowest catalog index;
empty slots come back with ``vals == -inf`` and an unspecified index.

``tree_merge_topk`` (with ``merge_topk_multi``) is the reference's
cross-shard merge of per-shard top-k carries, over torch tensors.

The mask is the stacked uint8 filter table (R, N) plus one table row
per query, not a (Q, N) float mask: the kernel reads the row itself.
A wrapper given CUDA tensors launches the kernel, one launch a call
(or raises); CPU tensors take the plain version, which computes the
same scores in the same order, so the two agree bit for bit.  The
kernel's grid is ``topk_plan``, a function of the shapes alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = float("-inf")
TILE = 128                              # csrc/router_topk.cu TILE: a chunk
                                        # is whole tiles of rows
WARPS = 8                               # warps of a block
SM_COUNT = 132                          # H100 SXM
BLOCKS_PER_SM = 2                       # blocks of the grid per SM
MAX_K = 32

_SIG = {"router_topk_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p]}


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of (B, M) ``x``, descending, ties toward the
    lowest column (``lax.top_k``'s order; ``torch.topk`` promises none).

    ``torch.topk`` fixes the k-th value t; every entry above t is in,
    and the tie slots at t go to the lowest columns.  One stable sort
    of the k survivors orders them.  Returns (vals, idx int64)."""
    B, M = x.shape
    if k >= M:
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]
    t = torch.topk(x, k, dim=1).values[:, -1:]
    above = x > t
    tie = x == t
    need = k - above.sum(dim=1, keepdim=True)
    keep = above | (tie & (torch.cumsum(tie, dim=1) <= need))
    idx = keep.nonzero()[:, 1].view(B, k)
    vals, order = torch.sort(x.gather(1, idx), dim=1, descending=True,
                             stable=True)
    return vals, idx.gather(1, order)


def _pow2_ge(x: int) -> int:
    """Smallest power of two >= x (x >= 1)."""
    return 1 << max(x - 1, 1).bit_length() if x > 1 else 1


def _bitonic_merge(av, bv, a_payloads, b_payloads):
    """The reference's bitonic merge of two sorted-descending (Q, k)
    carries, step for step, before its cut to k: the kp-wide result
    (kp = k rounded up to a power of two), sorted descending.

    Carries narrower than kp pad with -inf values, -1 integer payloads
    and 0 float payloads.  One reversal exchange keeps the kp largest
    of the 2kp (ties keep the ``a`` element), then log2(kp) bitonic
    stages sort them; every payload takes the values' keep mask, so
    lanes never mix."""
    assert len(a_payloads) == len(b_payloads)
    k = av.shape[1]
    kp = _pow2_ge(k)
    a_pl, b_pl = list(a_payloads), list(b_payloads)
    if kp != k:
        def pad(x, fill):
            return torch.cat([x, x.new_full((x.shape[0], kp - k), fill)],
                             dim=1)

        def fill(p):
            return 0 if p.is_floating_point() else -1

        av, bv = pad(av, NEG_INF), pad(bv, NEG_INF)
        a_pl = [pad(p, fill(p)) for p in a_pl]
        b_pl = [pad(p, fill(p)) for p in b_pl]
    rv = bv.flip(1)
    keep_a = av >= rv
    v = torch.where(keep_a, av, rv)
    pl = [torch.where(keep_a, pa, pb.flip(1)) for pa, pb in zip(a_pl, b_pl)]
    pos = torch.arange(kp, device=v.device)
    s = kp // 2
    while s >= 1:
        partner = pos ^ s
        pv = v[:, partner]
        first = ((pos & s) == 0)[None, :]       # lower index of each pair
        keep = torch.where(first, v >= pv, v <= pv)
        pl = [torch.where(keep, p, p[:, partner]) for p in pl]
        v = torch.where(keep, v, pv)
        s //= 2
    return v, pl


def merge_topk_multi(av, bv, a_payloads, b_payloads):
    """Top-k union of two sorted-descending (Q, k) carries, with any
    number of payload columns riding along every compare-exchange (the
    reference's ``merge_topk_multi``).  Returns (vals (Q, k), tuple of
    merged payloads)."""
    k = av.shape[1]
    v, pl = _bitonic_merge(av, bv, a_payloads, b_payloads)
    return v[:, :k], tuple(p[:, :k] for p in pl)


def merge_topk(av, ai, bv, bi):
    """Top-k of the union of two sorted-descending (Q, k) carries with
    their indices (one-payload ``merge_topk_multi``)."""
    v, (i,) = merge_topk_multi(av, bv, (ai,), (bi,))
    return v, i


def _value_then_index(v, pl, index: int):
    """Lanes re-ordered to value descending, then payload ``index``
    ascending among equal values."""
    o = torch.sort(pl[index], dim=1, stable=True).indices
    v, pl = v.gather(1, o), [p.gather(1, o) for p in pl]
    o = torch.sort(v, dim=1, descending=True, stable=True).indices
    return v.gather(1, o), tuple(p.gather(1, o) for p in pl)


def tree_merge_topk(vals, payloads, *, index: Optional[int] = None):
    """Pairwise-tree reduction of S sorted-descending per-shard carries
    into one (Q, k) top-k: the cross-shard step of the sharded
    ``route_step``.

    vals (S, Q, k) stacked per-shard values (shard-major); payloads a
    tuple of (S, Q, k) tensors.  Adjacent pairs merge per level
    (``merge_topk_multi``), the higher shard folding into the lower,
    as the reference does.  Its bitonic stages can leave equal values
    out of index order, and the cut to k (or a later level's exchange)
    then keeps the wrong ones of a tie that straddles it.  With
    ``index`` (the position of a payload holding global catalog
    indices), each merge's full kp-wide result is put in (value
    descending, index ascending) order before the cut: its exchange
    keeps a prefix of each canonical carry, so the kept set is right,
    and the result is the top-k of the concatenated catalog with ties
    to the lowest index, as a dense top-k gives.  Without it the result
    is the reference's, lane for lane.  Returns (vals (Q, k),
    tuple of payloads (Q, k))."""
    S = vals.shape[0]
    parts = [(vals[s], tuple(p[s] for p in payloads)) for s in range(S)]
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            (av, apl), (bv, bpl) = parts[i], parts[i + 1]
            if index is None:
                nxt.append(merge_topk_multi(av, bv, apl, bpl))
                continue
            k = av.shape[1]
            v, pl = _value_then_index(*_bitonic_merge(av, bv, apl, bpl),
                                      index)
            nxt.append((v[:, :k], tuple(p[:, :k] for p in pl)))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _finish(scores: torch.Tensor, mask_table, rows, k: int,
            bias: Optional[torch.Tensor], min_score: float):
    """Mask, bias, floor and top-k of a (Q, N) score matrix — the
    shared tail of both plain versions."""
    Q, N = scores.shape
    if bias is not None:
        scores = scores + bias[None, :]
    scores = torch.where(mask_table[rows.long()].bool(), scores, NEG_INF)
    if min_score != NEG_INF:
        scores = torch.where(scores >= min_score, scores, NEG_INF)
    if k > N:
        scores = torch.cat([scores, scores.new_full((Q, k - N), NEG_INF)],
                           dim=1)
    vals, idx = topk_stable(scores, k)
    return vals, idx.to(torch.int32)


def router_topk_plain(qn, embn, mask_table, rows, k: int, *, bias=None,
                      min_score: float = NEG_INF):
    """Plain PyTorch version of the fp32 kernel: the dot products are
    summed left to right over D with separate multiply and add
    roundings, exactly as the kernel does."""
    Q, D = qn.shape
    scores = qn.new_zeros((Q, embn.shape[0]))
    for d in range(D):
        scores = scores + qn[:, d, None] * embn[None, :, d]
    return _finish(scores, mask_table, rows, k, bias, min_score)


def router_topk_q8_plain(q8, e8, qscale, escale, mask_table, rows, k: int,
                         *, bias=None, min_score: float = NEG_INF):
    """Plain PyTorch version of the int8 kernel.  The int8 dot runs as
    an fp32 matmul of the integer values: every product and partial
    sum is an integer below 2**24 (|q|, |e| <= 127, D <= 64), so it is
    exact — the int32 accumulation of the kernel."""
    acc = q8.float() @ e8.float().T
    scores = acc * (qscale.reshape(-1, 1) * escale.reshape(1, -1))
    return _finish(scores, mask_table, rows, k, bias, min_score)


def queries_per_block(D: int) -> int:
    """Queries a block of the kernel takes: 8 warps of 4 queries where
    D <= 8 (each row a lane reads is scored for all of its warp's
    queries; csrc QW), else of one."""
    return WARPS * 4 if D <= 8 else WARPS


def topk_plan(Q: int, N: int, D: int) -> Tuple[int, int]:
    """(S, chunk) of the kernel's grid (query groups of
    ``queries_per_block``, S chunks of ``chunk`` catalog rows, a
    multiple of TILE): as many blocks as BLOCKS_PER_SM per SM hold at
    once (one wave), each chunk at least one tile; chunk s takes rows
    [s * chunk, min(N, (s + 1) * chunk)).  From the shapes alone."""
    groups = -(-Q // queries_per_block(D))
    s_target = max(1, BLOCKS_PER_SM * SM_COUNT // max(groups, 1))
    per = -(-max(N, 1) // s_target)
    chunk = max(TILE, -(-per // TILE) * TILE)
    return max(1, -(-N // chunk)), chunk


def _launch(quant: bool, q, e, qscale, escale, mask_table, rows, k, bias,
            min_score):
    dev = q.device
    Q, D = q.shape
    N = e.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"router_topk kernel takes 1 <= k <= {MAX_K}, "
                         f"got {k}")
    if not 1 <= D <= 64:
        raise ValueError(f"router_topk kernel takes 1 <= D <= 64, got {D}")
    want = [(q, (Q, D)), (e, (N, D)),
            (mask_table, (mask_table.shape[0], N)), (rows, (Q,))]
    if bias is not None:
        want.append((bias, (N,)))
    if quant:
        want += [(qscale, (Q,)), (escale, (N,))]
    for t, shape in want:
        if t.device != dev or not t.is_contiguous() or \
                tuple(t.shape) != shape:
            raise ValueError(f"router_topk: operand {tuple(t.shape)} on "
                             f"{t.device} must be contiguous {shape} on {dev}")
    dtype = torch.int8 if quant else torch.float32
    if q.dtype != dtype or e.dtype != dtype or mask_table.dtype != \
            torch.uint8 or rows.dtype != torch.int32:
        raise TypeError("router_topk: q/e must be "
                        f"{dtype}, mask_table uint8, rows int32")
    lib = build.load("router_topk", _SIG)
    S, chunk = topk_plan(Q, N, D)
    # each chunk's partial top-k, merged inside the launch
    pv = pi = None
    if S > 1:
        pv = torch.empty((Q, S, k), dtype=torch.float32, device=dev)
        pi = torch.empty((Q, S, k), dtype=torch.int32, device=dev)
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.router_topk_launch(
            q.data_ptr(), e.data_ptr(),
            qscale.data_ptr() if quant else None,
            escale.data_ptr() if quant else None,
            mask_table.data_ptr(), rows.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            float(min_score), Q, N, D, k, chunk, int(quant),
            pv.data_ptr() if pv is not None else None,
            pi.data_ptr() if pi is not None else None, vals.data_ptr(),
            idx.data_ptr(), stream)
    build.check(err, "router_topk")
    return vals, idx


def _on_card(t: torch.Tensor, kind: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{kind}: tensors must be on cuda or cpu, "
                         f"not {t.device}")
    return t.device.type == "cuda"


def router_topk(qn, embn, mask_table, rows, k: int, *, bias=None,
                min_score: float = NEG_INF):
    """fp32 top-k.  qn (Q, D) query rows; embn (N, D) catalog rows;
    mask_table (R, N) uint8 filter table; rows (Q,) int32 table row per
    query; bias (N,) f32 or None.  Returns (vals (Q, k) f32,
    idx (Q, k) int32)."""
    if not _on_card(qn, "router_topk"):
        return router_topk_plain(qn, embn, mask_table, rows, k, bias=bias,
                                 min_score=min_score)
    out = _launch(False, qn, embn, None, None, mask_table, rows, k, bias,
                  min_score)
    router_topk.launches += 1
    return out


def router_topk_q8(q8, e8, qscale, escale, mask_table, rows, k: int, *,
                   bias=None, min_score: float = NEG_INF):
    """int8 top-k.  q8 (Q, D) / e8 (N, D) int8 row-quantized rows with
    qscale (Q,) / escale (N,) f32 per-row scales; the rest as
    ``router_topk``."""
    if not _on_card(q8, "router_topk_q8"):
        return router_topk_q8_plain(q8, e8, qscale, escale, mask_table,
                                    rows, k, bias=bias, min_score=min_score)
    out = _launch(True, q8, e8, qscale, escale, mask_table, rows, k, bias,
                  min_score)
    router_topk_q8.launches += 1
    return out


router_topk.launches = 0
router_topk_q8.launches = 0
