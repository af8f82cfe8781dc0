"""Online-softmax attention: wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the Pallas ``flash_attention_pallas`` (the JAX package's
``kernels/flash_attention.py``).  Same contract: q (B, Hq, Lq, hd),
k / v (B, Hkv, Lk, hd) with Hq % Hkv == 0 and kv head = q head //
(Hq / Hkv); scores ``(q . k) / sqrt(hd)`` with the true hd, an optional
tanh softcap, then the mask -- ``ik < kv_valid[b]`` and, with
``causal``, ``ik <= row`` and ``ik > row - window`` where ``row = iq +
Lk - Lq`` (the ends aligned) -- softmax over the live keys, times v.
f32 inside; the output in q's dtype; a row with no live key gives 0.
``kv_valid`` (B,) int32 is the per-sequence live key count (decode
against a partly filled cache); None means all Lk keys.  The decode
shape (Lq == 1) also takes ``local_window`` W: only the keys
``kv_valid[b] - W <= ik < kv_valid[b]`` are live, a window that ends
at each sequence's own position (gemma2's local layers, whose cache is
full length), where ``causal``/``window`` end it at Lk for the whole
batch; and ``kv_first`` (B,) int32, each row's first live slot
(``ik >= kv_first[b]``): one rank's block of a cache sharded by length,
whose live range may start inside the block or past it.  Head dims 32,
64, 120, 128 and 288: 120 (h2o-danube-3-4b) runs in the 128
instantiations with zero columns past it, 288 (gemma2-2b) has its own.

An int8 KV cache decodes through ``flash_decode_q8``: int8 K/V (B,
Hkv, Lk, hd) with f32 per-(slot, head) scales (B, Hkv, Lk, 1), each
element dequantized to ``bf16(bf16(k8) * bf16(scale))`` as the
reference's jnp decode does, then the same split-KV decode and merge
(``decode_q8_plain`` is its plain version).

The tensors may be strided views (the head dim contiguous): the
model's (B, L, H, hd) activations and its KV cache go in as
``transpose(1, 2)`` views, without a copy.  A wrapper given CUDA
tensors launches the kernel (or raises); CPU tensors take the plain
version.  The decode shape (Lq == 1) runs the body ``decode_body``
names (counted in ``flash_attention.decode_launches_by_body``) and
splits the cache into chunks chosen from the shapes alone
(``decode_splits``, ``wide_splits``); ``decode_split_plain`` is the
split-and-merge arithmetic in plain PyTorch.  A decode of one split on
``decode_mma_kernel`` is one launch (``one_launch``).

The decode shape with ``return_lse`` gives a partial: (o in f32, the
rows' log-sum-exp), the same launch writing both (the combine's lse
output).  ``decode_merge`` merges R such partials -- the ranks' blocks
of a cache sharded by length -- in rank order, through the same
combine body (``decode_merge_plain`` is its plain version).

The backward (``flash_attention_bwd``, plain version
``flash_attention_bwd_plain``) takes the forward's output and its
per-row log-sum-exp, which the forward returns with ``return_lse``,
and recomputes the probabilities from them:
FlashAttention-2's form, three launches (delta, dK/dV, dQ) on the card,
through the body ``bwd_body`` names: ``"wgmma"`` (TMA rings and wgmma)
for bf16 at head dims 64, 120, 128 and 288 with q, k, v and do on 16
bytes, ``"mma"`` (mma.sync) for other bf16 operands, ``"f32"`` (CUDA
cores) for f32 ones.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 120, 128, 288)     # csrc/flash_attention.cu dispatch
NEG_INF = float("-inf")
LOG2E = 1.4426950408889634
SM_COUNT = 132                          # H100 SXM
MIN_CHUNK = 64                          # fewest keys a decode split takes

_SIG = {"flash_attention_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_longlong] * 12 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    "flash_decode_q8_launch": [
    ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 18 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p],
    "flash_decode_one_launch": [ctypes.c_int] * 4,
    "flash_decode_merge_launch": [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
    "flash_attention_bwd_launch": [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                             ctypes.c_int, ctypes.c_float, ctypes.c_int,
                             ctypes.c_void_p]}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
BWD_BODIES = ("f32", "mma", "wgmma")    # the C launch's body codes
WGMMA_BWD_HEAD_DIMS = (64, 120, 128, 288)
DECODE_BODIES = ("cores", "mma", "wide")  # the decode launch's body codes


def _live_mask(B: int, Lq: int, Lk: int, kv_valid, causal: bool,
               window: int, device, local_window: int = 0,
               kv_first=None) -> torch.Tensor:
    """(B, 1, 1, Lq, Lk) bool: the keys each query row may see."""
    iq = torch.arange(Lq, device=device)[:, None]
    ik = torch.arange(Lk, device=device)[None, :]
    ok = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        row = iq + (Lk - Lq)
        ok = ik <= row
        if window:
            ok = ok & (ik > row - window)
    ok = ok[None]
    if kv_valid is not None or local_window:
        live = torch.full((B, 1, 1), Lk, device=device) if kv_valid is None \
            else kv_valid.to(device).reshape(B, 1, 1).clamp(max=Lk)
        ok = ok & (ik[None] < live)
        if local_window:
            ok = ok & (ik[None] >= live - local_window)
    if kv_first is not None:
        ok = ok & (ik[None] >= kv_first.to(device).reshape(B, 1, 1))
    return ok[:, None, None]


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' working type: f32, or f64 for f64 operands
    (the gradient checks)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _scores(q, k, kv_valid, causal, window, softcap, local_window=0,
            kv_first=None):
    """Masked, softcapped scores (B, Hkv, G, Lq, Lk) in the working type,
    the mask, and tanh(s / softcap) (None without a softcap)."""
    B, Hq, Lq, hd = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    qf = _acc(q).reshape(B, Hkv, Hq // Hkv, Lq, hd)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qf, _acc(k)) / math.sqrt(hd)
    th = None
    if softcap:
        th = torch.tanh(s / softcap)
        s = softcap * th
    ok = _live_mask(B, Lq, Lk, kv_valid, causal, window, q.device,
                    local_window, kv_first)
    return torch.where(ok, s, NEG_INF), ok, th


def flash_attention_plain(q, k, v, kv_valid=None, *, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          local_window: int = 0, return_lse: bool = False,
                          kv_first=None):
    """Plain PyTorch version: masked f32 scores -> softmax -> values,
    the (m, l) guard of the kernel written out (no live key: 0).  With
    ``return_lse`` also the rows' log-sum-exp (B, Hq, Lq) f32 (+inf on a
    row with no live key), what the backward and ``decode_merge``
    read."""
    B, Hq, Lq, hd = q.shape
    s, ok, _ = _scores(q, k, kv_valid, causal, window, softcap,
                       local_window, kv_first)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m == NEG_INF, torch.zeros_like(m), m)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqm,bkmd->bkgqd", p, _acc(v))
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    o = o.reshape(B, Hq, Lq, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                      float("inf"))
    return o, lse.reshape(B, Hq, Lq).to(_acc(q).dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid=None, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0):
    """The backward in plain PyTorch, the kernel's arithmetic: P =
    exp(s - lse) recomputed from the scores and the forward's lse, dV =
    P^T dO, dP = dO V^T, delta = rowsum(dO o), dS = P (dP - delta)
    (times 1 - tanh^2 with a softcap) / sqrt(hd), dQ = dS K, dK = dS^T
    Q; the G query heads of a group summed into their KV head.  Returns
    (dq, dk, dv) in the operands' types."""
    B, Hq, Lq, hd = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    s, ok, th = _scores(q, k, kv_valid, causal, window, softcap)
    lse5 = _acc(lse).reshape(B, Hkv, G, Lq, 1)
    p = torch.where(ok, torch.exp(s - lse5), 0.0)
    dof = _acc(do).reshape(B, Hkv, G, Lq, hd)
    dv = torch.einsum("bkgqm,bkgqd->bkmd", p, dof)
    dp = torch.einsum("bkgqd,bkmd->bkgqm", dof, _acc(v))
    delta = (dof * _acc(o).reshape(B, Hkv, G, Lq, hd)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if softcap:
        ds = ds * (1 - th * th)
    ds = ds / math.sqrt(hd)
    dq = torch.einsum("bkgqm,bkmd->bkgqd", ds, _acc(k))
    dk = torch.einsum("bkgqm,bkgqd->bkmd", ds,
                      _acc(q).reshape(B, Hkv, G, Lq, hd))
    return (dq.reshape(B, Hq, Lq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _split_plan(B: int, Hkv: int, Lk: int, per_sm: int, unit: int):
    """(n_split, chunk): the Lk cache slots cut into n_split chunks of
    ``chunk`` keys (a multiple of ``unit``), so that the grid (n_split,
    Hkv, B) puts at least ``per_sm`` blocks on each of the card's SMs
    where the cache is long enough (chunks of at least ``unit`` keys)."""
    want = -(-per_sm * SM_COUNT // max(B * Hkv, 1))
    n = max(1, min(want, -(-Lk // unit)))
    per = -(-Lk // n)
    chunk = max(unit, -(-per // unit) * unit)
    return max(1, -(-Lk // chunk)), chunk


def decode_splits(B: int, Hkv: int, Lk: int):
    """(n_split, chunk) of the decode launch on the ``"mma"`` and
    ``"cores"`` bodies: two blocks on each SM, chunks a multiple of
    MIN_CHUNK keys (``_split_plan``).  Decided from the shapes alone:
    the live lengths stay on the card, and a block whose chunk holds no
    live key writes an empty partial."""
    return _split_plan(B, Hkv, Lk, 2, MIN_CHUNK)


def wide_splits(B: int, Hkv: int, Lk: int):
    """(n_split, chunk) of the hd-288 tensor-core decode
    (``decode_wide_kernel``, bf16 or int8 cache): three blocks on each
    SM, what its shared memory allows (73.5 KB with the bf16 cache's
    2-stage ring, 56.8 KB with the int8 stage), in chunks of whole
    32-key passes."""
    return _split_plan(B, Hkv, Lk, 3, 32)


def decode_body(q, k) -> str:
    """The decode body that takes these operands (q (B, Hq, 1, hd), k
    (B, Hkv, Lk, hd)): the tensor cores for bf16 with a GQA group of at
    most 16 and q's rows on 4 bytes (read as bf16 pairs) -- ``"mma"``
    (``decode_mma_kernel``) at head dims up to 128, ``"wide"``
    (``decode_wide_kernel``) at 288 -- and ``"cores"``
    (``decode_split_kernel``) for the rest: f32, G > 16.  Decided from
    dtypes, shapes, strides and addresses alone."""
    G = q.shape[1] // max(k.shape[1], 1)
    if q.dtype == torch.bfloat16 and G <= 16 and q.data_ptr() % 4 == 0 \
            and all(st % 2 == 0 for st in q.stride()[:2]):
        if q.shape[3] <= 128:
            return "mma"
        if q.shape[3] == 288:
            return "wide"
    return "cores"


def one_launch(n_split: int, return_lse: bool, body: str, hd: int,
               lib=None) -> bool:
    """Whether a decode launch is its body alone, as ``lib`` (the card's
    library by default) rules (``flash_decode_one_launch``): then it
    writes its rows normalized in the output's type with no f32 scratch
    and no ``decode_combine_kernel`` launch.  ``body`` is a name of
    ``DECODE_BODIES`` or ``Q8_BODIES``."""
    if lib is None:
        lib = build.load("flash_attention", _SIG)
    return bool(lib.flash_decode_one_launch(
        n_split, int(bool(return_lse)), DECODE_BODIES.index(body), hd))


def decode_split_plain(q, k, v, kv_valid=None, *, causal: bool = False,
                       window: int = 0, softcap: float = 0.0,
                       local_window: int = 0, splits=None):
    """The decode kernel's arithmetic in plain PyTorch, for Lq = 1:
    per chunk of ``decode_splits`` (or ``splits``) the partial (m, l,
    acc) in the log2 domain over the chunk's live keys, then the
    partials merged in split order, skipping those with no live key.
    A row with no live key gives 0."""
    B, Hq, Lq, hd = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if Lq != 1:
        raise ValueError("decode_split_plain takes one query row")
    n_split, chunk = splits or decode_splits(B, Hkv, Lk)
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, hd) / math.sqrt(hd)
    s = torch.einsum("bkgd,bkmd->bkgm", qf, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = s * LOG2E
    ok = _live_mask(B, 1, Lk, kv_valid, causal, window, q.device,
                    local_window)
    ok = ok.reshape(B, 1, 1, Lk)
    M = torch.full((B, Hkv, G, 1), NEG_INF, device=q.device)
    parts = []
    for i in range(n_split):
        sl = slice(i * chunk, min(Lk, (i + 1) * chunk))
        si = torch.where(ok[..., sl], s[..., sl], NEG_INF)
        m = si.amax(dim=-1, keepdim=True)
        use = torch.where(m == NEG_INF, torch.zeros_like(m), m)
        p = torch.exp2(si - use)
        acc = torch.einsum("bkgm,bkmd->bkgd", p, v[:, :, sl].float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros((B, Hkv, G, hd), device=q.device)
    M = torch.where(M == NEG_INF, torch.zeros_like(M), M)
    for m, l, acc in parts:                       # split order
        f = torch.where(m == NEG_INF, torch.zeros_like(m), torch.exp2(m - M))
        L = L + l * f
        A = A + acc * f
    o = torch.where(L > 0, A / torch.where(L > 0, L, 1.0), 0.0)
    return o.reshape(B, Hq, 1, hd).to(q.dtype)


def _check_rows(name, t, B, dev):
    """``kv_valid`` / ``kv_first``: None or a contiguous (B,) int32
    tensor on ``dev``."""
    if t is not None and (t.device != dev or t.dtype != torch.int32 or
                          tuple(t.shape) != (B,) or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous ({B},) int32 tensor "
                         f"on {dev}")


def _check(q, k, v, kv_valid, kv_first=None):
    dev = q.device
    B, Hq, Lq, hd = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel: q, k, v must all be "
                        f"float32 or bfloat16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if k.shape != (B, Hkv, Lk, hd) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    for t in (q, k, v):
        if t.device != dev:
            raise ValueError("flash_attention: q, k, v on different devices")
        # vector loads: head dim contiguous, 16-byte aligned rows
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) or \
                t.data_ptr() % 16:
            raise ValueError(f"flash_attention: operand strides "
                             f"{t.stride()} need a contiguous head dim and "
                             "16-byte aligned rows")
    # the decode shape copies K/V rows 16 bytes at a time
    if Lq == 1 and any(s * q.element_size() % 16 for t in (k, v)
                       for s in t.stride()[:3]):
        raise ValueError(f"flash_attention decode: K/V strides "
                         f"{k.stride()} / {v.stride()} need 16-byte rows")
    _check_rows("flash_attention: kv_valid", kv_valid, B, dev)
    _check_rows("flash_attention: kv_first", kv_first, B, dev)


def _fwd_launch(lib, stream, q, k, v, kv_valid, causal, window, softcap,
                local_window, return_lse, kv_first=None):
    """One forward through ``lib`` (the card's library, or any ctypes
    handle with its entry point) on checked operands: allocates the
    output as a ``transpose(1, 2)`` view of a contiguous (B, Lq, Hq, hd)
    tensor (f32 for the decode shape's partial, ``return_lse``), the lse
    and the decode shape's split plan and f32 scratch on q's device, and
    raises on a non-zero return.  Returns out, or (out, lse) with
    ``return_lse``."""
    B, Hq, Lq, hd = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    odt = torch.float32 if return_lse and Lq == 1 else q.dtype
    out = torch.empty((B, Lq, Hq, hd), dtype=odt,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, Hq, Lq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    n_split, chunk, scratch, body = 0, 0, None, "cores"
    if Lq == 1:                         # partials (acc, then m and l), f32
        body = decode_body(q, k)
        n_split, chunk = (wide_splits if body == "wide" else
                          decode_splits)(B, Hkv, Lk)
        if not one_launch(n_split, return_lse, body, hd, lib):
            scratch = torch.empty(B * Hq * n_split * (hd + 2),
                                  dtype=torch.float32, device=q.device)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(),
        out.data_ptr(), _DTYPE[q.dtype], B, Hq, Hkv, Lq, Lk, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], 1.0 / math.sqrt(hd), int(bool(causal)),
        int(window), float(softcap), int(local_window),
        None if kv_first is None else kv_first.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n_split, chunk,
        DECODE_BODIES.index(body), None if lse is None else lse.data_ptr(),
        stream)
    build.check(err, f"flash_attention ({body} body)" if Lq == 1 else
                "flash_attention")
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, kv_valid=None, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    local_window: int = 0, return_lse: bool = False,
                    kv_first=None):
    """q (B, Hq, Lq, hd); k, v (B, Hkv, Lk, hd); kv_valid and kv_first
    (B,) int32 or None.  Returns (B, Hq, Lq, hd) in q's dtype.  On the
    card the result is a ``transpose(1, 2)`` view of a contiguous (B,
    Lq, Hq, hd) tensor, the model's layout.  Lq == 1 launches the decode
    shape on the body ``decode_body`` names: split-KV partials into f32
    scratch, then their ordered merge (one split on the ``"mma"`` body
    without lse: the body alone, ``one_launch``); only it takes ``local_window``
    and ``kv_first``.  ``return_lse``: (out, the rows' log-sum-exp (B,
    Hq, Lq) f32, +inf where no key is live), the same launch writing
    both; on the decode shape out is then f32, a partial for
    ``decode_merge``."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: tensors must be on cuda or "
                         f"cpu, not {q.device}")
    if local_window < 0 or ((local_window or kv_first is not None)
                            and q.shape[2] != 1):
        raise ValueError(f"flash_attention: local_window {local_window} "
                         "and kv_first need one query row (the decode "
                         "shape)")
    if q.device.type == "cpu":
        if return_lse and q.shape[2] == 1:      # the partial: o in f32
            q, k, v = _acc(q), _acc(k), _acc(v)
        return flash_attention_plain(q, k, v, kv_valid, causal=causal,
                                     window=window, softcap=softcap,
                                     local_window=local_window,
                                     return_lse=return_lse,
                                     kv_first=kv_first)
    _check(q, k, v, kv_valid, kv_first)
    lib = build.load("flash_attention", _SIG)
    with torch.cuda.device(q.device):
        res = _fwd_launch(lib, torch.cuda.current_stream(q.device).cuda_stream,
                          q, k, v, kv_valid, causal, window, softcap,
                          local_window, return_lse, kv_first)
    flash_attention.launches += 1
    if q.shape[2] == 1:
        flash_attention.decode_launches += 1
        flash_attention.decode_launches_by_body[decode_body(q, k)] += 1
    return res


# launches on the card: all of them, those of the decode shape, and those
# by decode body
flash_attention.launches = 0
flash_attention.decode_launches = 0
flash_attention.decode_launches_by_body = dict.fromkeys(DECODE_BODIES, 0)


def _tma_ok(t) -> bool:
    """Whether TMA can read ``t`` (B, H, L, hd) in bf16: a 16-byte
    aligned base and every (batch, head, position) stride of an axis
    longer than 1 a positive multiple of 16 bytes (``tma_ok`` in
    ``csrc/flash_attention.cu``)."""
    return t.data_ptr() % 16 == 0 and all(
        st > 0 and st * t.element_size() % 16 == 0
        for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def bwd_body(q, k, v, do) -> str:
    """The backward body that takes these operands: ``"f32"`` for f32
    ones; ``"wgmma"`` for bf16 at head dims 64, 120, 128 and 288 whose q,
    k, v and do TMA can read (``_tma_ok``; at 288 the wide kernels of
    ``csrc/flash_attention_bwd.cuh``); ``"mma"`` for every other bf16
    shape (hd 32, rows off 16 bytes).  Decided from dtypes, shapes,
    strides and addresses alone."""
    if q.dtype == torch.float32:
        return "f32"
    if q.shape[3] in WGMMA_BWD_HEAD_DIMS and all(
            _tma_ok(t) for t in (q, k, v, do)):
        return "wgmma"
    return "mma"


def _bwd_launch(lib, stream, q, k, v, o, lse, do, kv_valid, causal, window,
                softcap, body):
    """One backward through ``lib`` (the card's library, or any ctypes
    handle with its entry point) with ``body``; allocates dq, dk, dv as
    ``transpose(1, 2)`` views of contiguous (B, L, H, hd) tensors on q's
    device and delta's scratch, and raises on a non-zero return."""
    B, Hq, Lq, hd = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    dev = q.device
    dq = torch.empty((B, Lq, Hq, hd), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Lk, Hkv, hd), dtype=k.dtype, device=dev)
    dv = torch.empty((B, Lk, Hkv, hd), dtype=v.dtype, device=dev)
    dq, dk, dv = (t.transpose(1, 2) for t in (dq, dk, dv))
    delta = torch.empty((B, Hq, Lq), dtype=torch.float32, device=dev)
    strides = torch.tensor([s for t in (q, k, v, o, do, dq, dk, dv)
                            for s in t.stride()[:3]], dtype=torch.int64)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        _DTYPE[q.dtype], B, Hq, Hkv, Lq, Lk, hd, strides.data_ptr(),
        1.0 / math.sqrt(hd), int(bool(causal)), int(window),
        float(softcap), BWD_BODIES.index(body), stream)
    build.check(err, f"flash_attention_bwd ({body} body)")
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, kv_valid=None, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """The gradients (dq, dk, dv) of ``flash_attention`` (prefill shapes)
    from its operands, its output ``o`` and log-sum-exp ``lse`` and the
    output's gradient ``do`` (any strides, the head dim contiguous).  On
    the card the body ``bwd_body`` names runs (or the call raises) and
    the gradients are ``transpose(1, 2)`` views of contiguous (B, L, H,
    hd) tensors, the model's layout; CPU tensors take
    ``flash_attention_bwd_plain``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid,
                                         causal=causal, window=window,
                                         softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: tensors must be on cuda "
                         f"or cpu, not {q.device}")
    B, Hq, Lq, hd = q.shape
    if Lq == 1:
        raise ValueError("flash_attention_bwd: the decode shape (Lq == 1) "
                         "takes no gradient")
    _check(q, k, v, kv_valid)
    for t in (o, do):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd: o / do {tuple(t.shape)} "
                             f"{t.dtype} must match q with a contiguous "
                             "head dim")
    lse = lse.contiguous()
    if lse.shape != (B, Hq, Lq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be ({B}, {Hq}, "
                         f"{Lq}) float32, got {tuple(lse.shape)} {lse.dtype}")
    body = bwd_body(q, k, v, do)
    lib = build.load("flash_attention", _SIG)
    with torch.cuda.device(q.device):
        out = _bwd_launch(lib, torch.cuda.current_stream(q.device).cuda_stream,
                          q, k, v, o, lse, do, kv_valid, causal, window,
                          softcap, body)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_body[body] += 1
    return out


# launches on the card, and by body
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_body = dict.fromkeys(BWD_BODIES, 0)


# ----------------------------------------------------------------------
# decode against an int8 KV cache
# ----------------------------------------------------------------------

Q8_CHUNK = 32                           # the int8 decode's chunk unit
Q8_BODIES = ("cores", "mma")            # the C launch's body codes
MMA_Q8_HEAD_DIMS = (64, 120, 128, 288)


def q8_body(q, k8) -> str:
    """The int8 decode body that takes these operands: ``"mma"`` (the
    tensor cores: ``decode_mma_kernel<HD, true>``, at hd 288
    ``decode_wide_kernel<288, true>``) for bf16 queries at head dims 64,
    120, 128 and 288 with a GQA group of at most 16 and q's rows on 4 bytes
    (read as bf16 pairs); ``"cores"`` (``decode_q8_kernel``) for the
    rest: f32 queries, hd 32, G > 16.  Decided from dtypes, shapes,
    strides and addresses alone."""
    G = q.shape[1] // max(k8.shape[1], 1)
    if q.dtype == torch.bfloat16 and q.shape[3] in MMA_Q8_HEAD_DIMS and \
            G <= 16 and q.data_ptr() % 4 == 0 and \
            all(st % 2 == 0 for st in q.stride()[:2]):
        return "mma"
    return "cores"


def q8_splits(B: int, Hkv: int, Lk: int, hd: int, body: str):
    """(n_split, chunk) of the int8 decode launch for ``body``: the
    tensor-core body takes the bf16 decode's plan (it is the same body
    with int8 tiles): ``decode_splits`` at hd 64, 120 and 128,
    ``wide_splits`` at 288; the CUDA-core body ``decode_splits_q8``."""
    if body == "cores":
        return decode_splits_q8(B, Hkv, Lk)
    if hd == 288:
        return wide_splits(B, Hkv, Lk)
    return decode_splits(B, Hkv, Lk)


def decode_splits_q8(B: int, Hkv: int, Lk: int):
    """(n_split, chunk) of the CUDA-core int8 decode launch: as
    ``decode_splits``, but for six blocks on each SM and chunks a
    multiple of ``Q8_CHUNK`` keys.  Its blocks dequantize and score their
    chunk one sub-tile at a time, so more of them must be in flight to
    keep the card's memory busy."""
    return _split_plan(B, Hkv, Lk, 6, Q8_CHUNK)


def dequantize_kv(x8, scale):
    """The reference's dequantized cache: ``bf16(x8) * bf16(scale)``
    rounded to bf16 (``models/layers.py``'s int8 decode casts both to
    bf16 first, whatever the compute dtype).  bf16 holds every int8
    value exactly and the product of two bf16 values exactly in f32, so
    this is the correctly rounded product: the kernel forms the same
    bits."""
    return x8.to(torch.bfloat16) * scale.to(torch.bfloat16)


def decode_q8_plain(q, k8, v8, k_scale, v_scale, kv_valid=None, *,
                    softcap: float = 0.0, local_window: int = 0,
                    return_lse: bool = False, kv_first=None):
    """Plain version of ``flash_decode_q8``: the K/V dequantized as the
    reference does (``dequantize_kv``), then the plain decode
    (``flash_attention_plain``, no causal mask: one query row against
    its ``kv_valid`` live keys from ``kv_first``).  ``return_lse``: the
    partial (o in f32, lse), as ``flash_attention``'s decode shape."""
    k, v = dequantize_kv(k8, k_scale), dequantize_kv(v8, v_scale)
    if return_lse:
        q, k, v = _acc(q), _acc(k), _acc(v)
    return flash_attention_plain(q, k, v, kv_valid, causal=False,
                                 softcap=softcap, local_window=local_window,
                                 return_lse=return_lse, kv_first=kv_first)


def _check_q8(q, k8, v8, k_scale, v_scale, kv_valid, kv_first=None):
    dev = q.device
    B, Hq, Lq, hd = q.shape
    Hkv, Lk = k8.shape[1], k8.shape[2]
    if Lq != 1:
        raise ValueError("flash_decode_q8 takes one query row")
    if q.dtype not in _DTYPE or k8.dtype != torch.int8 or \
            v8.dtype != torch.int8 or k_scale.dtype != torch.float32 or \
            v_scale.dtype != torch.float32:
        raise TypeError(f"flash_decode_q8: q f32/bf16, int8 K/V and f32 "
                        f"scales, got {q.dtype}/{k8.dtype}/{v8.dtype}/"
                        f"{k_scale.dtype}/{v_scale.dtype}")
    if hd not in HEAD_DIMS or hd % 8:
        raise ValueError(f"flash_decode_q8 takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if k8.shape != (B, Hkv, Lk, hd) or v8.shape != k8.shape or Hq % Hkv \
            or k_scale.shape != (B, Hkv, Lk, 1) or \
            v_scale.shape != k_scale.shape:
        raise ValueError(f"flash_decode_q8: q {tuple(q.shape)}, k8 "
                         f"{tuple(k8.shape)}, v8 {tuple(v8.shape)}, scales "
                         f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)} "
                         "do not fit")
    for t in (q, k8, v8, k_scale, v_scale):
        if t.device != dev:
            raise ValueError("flash_decode_q8: operands on different "
                             "devices")
    if q.stride(3) != 1 or k8.stride(3) != 1 or v8.stride(3) != 1:
        raise ValueError("flash_decode_q8: the head dim must be contiguous")
    # int8 rows move 8 bytes at a time
    if any(x % 8 for t in (k8, v8) for x in t.stride()[:3]) or \
            k8.data_ptr() % 8 or v8.data_ptr() % 8:
        raise ValueError(f"flash_decode_q8: K/V strides {k8.stride()} / "
                         f"{v8.stride()} need 8-byte aligned rows")
    _check_rows("flash_decode_q8: kv_valid", kv_valid, B, dev)
    _check_rows("flash_decode_q8: kv_first", kv_first, B, dev)


def _q8_launch(lib, stream, q, k8, v8, k_scale, v_scale, kv_valid, softcap,
               local_window, body, kv_first=None, return_lse=False):
    """One int8 decode through ``lib`` (the card's library, or any ctypes
    handle with its entry point) with ``body``, on checked operands:
    allocates the output as a ``transpose(1, 2)`` view of a contiguous
    (B, 1, Hq, hd) tensor (f32 with ``return_lse``, then the lse too)
    and the split plan's f32 scratch on q's device, and raises on a
    non-zero return."""
    B, Hq, _, hd = q.shape
    Hkv, Lk = k8.shape[1], k8.shape[2]
    out = torch.empty((B, 1, Hq, hd),
                      dtype=torch.float32 if return_lse else q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, Hq, 1), dtype=torch.float32,
                      device=q.device) if return_lse else None
    n_split, chunk = q8_splits(B, Hkv, Lk, hd, body)
    scratch = None if one_launch(n_split, return_lse, body, hd, lib) else \
        torch.empty(B * Hq * n_split * (hd + 2), dtype=torch.float32,
                    device=q.device)
    err = lib.flash_decode_q8_launch(
        q.data_ptr(), k8.data_ptr(), v8.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), None if kv_valid is None else kv_valid.data_ptr(),
        out.data_ptr(), _DTYPE[q.dtype], B, Hq, Hkv, Lk, hd,
        *q.stride()[:3], *k8.stride()[:3], *v8.stride()[:3],
        *k_scale.stride()[:3], *v_scale.stride()[:3], *out.stride()[:3],
        1.0 / math.sqrt(hd), float(softcap), int(local_window),
        None if kv_first is None else kv_first.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n_split, chunk,
        Q8_BODIES.index(body),
        None if lse is None else lse.data_ptr(), stream)
    build.check(err, f"flash_decode_q8 ({body} body)")
    return (out, lse) if return_lse else out


def flash_decode_q8(q, k8, v8, k_scale, v_scale, kv_valid=None, *,
                    softcap: float = 0.0, local_window: int = 0,
                    return_lse: bool = False, kv_first=None):
    """One query row against an int8 KV cache: q (B, Hq, 1, hd) f32 or
    bf16; k8 / v8 (B, Hkv, Lk, hd) int8 and k_scale / v_scale (B, Hkv,
    Lk, 1) f32, possibly strided views of the model's cache; kv_valid
    and kv_first (B,) int32 or None; ``local_window``, ``kv_first`` and
    ``return_lse`` as ``flash_attention``'s decode shape.  Returns (B,
    Hq, 1, hd) in q's dtype (on the card a ``transpose(1, 2)`` view of a
    contiguous (B, 1, Hq, hd) tensor), or the partial (o f32, lse (B,
    Hq, 1) f32).  CPU tensors take ``decode_q8_plain``; CUDA tensors
    launch the body ``q8_body`` names (or raise), counted in
    ``launches_by_body``."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_decode_q8: tensors must be on cuda or "
                         f"cpu, not {q.device}")
    if local_window < 0:
        raise ValueError(f"flash_decode_q8: local_window {local_window}")
    if q.device.type == "cpu":
        return decode_q8_plain(q, k8, v8, k_scale, v_scale, kv_valid,
                               softcap=softcap, local_window=local_window,
                               return_lse=return_lse, kv_first=kv_first)
    _check_q8(q, k8, v8, k_scale, v_scale, kv_valid, kv_first)
    body = q8_body(q, k8)
    lib = build.load("flash_attention", _SIG)
    with torch.cuda.device(q.device):
        out = _q8_launch(lib, torch.cuda.current_stream(q.device).cuda_stream,
                         q, k8, v8, k_scale, v_scale, kv_valid, softcap,
                         local_window, body, kv_first, return_lse)
    flash_decode_q8.launches += 1
    flash_decode_q8.launches_by_body[body] += 1
    return out


# launches on the card, and by body
flash_decode_q8.launches = 0
flash_decode_q8.launches_by_body = dict.fromkeys(Q8_BODIES, 0)


# ----------------------------------------------------------------------
# the merge of a decode's partials across ranks
# ----------------------------------------------------------------------

def decode_merge_plain(o_parts, lse_parts, dtype=torch.float32):
    """Plain version of ``decode_merge``, the combine's arithmetic: each
    part (o, lse) read as a split with acc = o and l = 1, weighted by
    exp2((lse - max lse) log2(e)), merged in part order; a part with lse
    = +inf (no live key) is skipped, and a row with none live gives 0."""
    m = torch.where(lse_parts == float("inf"), NEG_INF, lse_parts.float())
    M = m.amax(dim=0)
    M = torch.where(M == NEG_INF, torch.zeros_like(M), M)
    L = torch.zeros_like(M)
    A = torch.zeros(o_parts.shape[1:], dtype=torch.float32,
                    device=o_parts.device)
    for r in range(o_parts.shape[0]):             # part order
        f = torch.where(m[r] == NEG_INF, torch.zeros_like(M),
                        torch.exp2((m[r] - M) * LOG2E))
        L = L + f
        A = A + o_parts[r].float() * f[..., None]
    o = torch.where(L[..., None] > 0, A / torch.where(L > 0, L, 1.0)[
        ..., None], 0.0)
    return o.to(dtype)


def decode_merge(o_parts, lse_parts, dtype=torch.float32):
    """R ranks' decode partials merged into one decode: o_parts (R, B,
    Hq, 1, hd) f32 and lse_parts (R, B, Hq, 1) f32, rank r's
    ``flash_attention``/``flash_decode_q8`` with ``return_lse`` over its
    block of the cache's slots.  Returns (B, Hq, 1, hd) in ``dtype`` (on
    the card a ``transpose(1, 2)`` view of a contiguous (B, 1, Hq, hd)
    tensor): the decode over the union of the blocks.  On the card one
    launch of the decode's combine body with each part as a split, in
    rank order, no atomics: the same bits on every run; CPU tensors take
    ``decode_merge_plain``."""
    R = o_parts.shape[0]
    if o_parts.ndim != 5 or o_parts.shape[3] != 1 or R < 1 or \
            tuple(lse_parts.shape) != tuple(o_parts.shape[:4]):
        raise ValueError(f"decode_merge: o_parts {tuple(o_parts.shape)} "
                         f"and lse_parts {tuple(lse_parts.shape)} are not "
                         "(R, B, Hq, 1, hd) and (R, B, Hq, 1)")
    if o_parts.device.type == "cpu":
        return decode_merge_plain(o_parts, lse_parts, dtype)
    if o_parts.device.type != "cuda" or lse_parts.device != o_parts.device:
        raise ValueError(f"decode_merge: tensors must be on cuda or cpu, "
                         f"not {o_parts.device} / {lse_parts.device}")
    if o_parts.dtype != torch.float32 or lse_parts.dtype != torch.float32 \
            or dtype not in _DTYPE:
        raise TypeError(f"decode_merge: f32 parts into f32 or bf16, got "
                        f"{o_parts.dtype} / {lse_parts.dtype} into {dtype}")
    _, B, Hq, _, hd = o_parts.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_merge takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    lib = build.load("flash_attention", _SIG)
    with torch.cuda.device(o_parts.device):
        out = _merge_launch(lib, torch.cuda.current_stream(
            o_parts.device).cuda_stream, o_parts, lse_parts, dtype)
    decode_merge.launches += 1
    return out


def _merge_launch(lib, stream, o_parts, lse_parts, dtype):
    """One merge through ``lib`` (the card's library, or any ctypes handle
    with its entry point): the parts made contiguous, the output
    allocated as a ``transpose(1, 2)`` view of a contiguous (B, 1, Hq,
    hd) tensor; raises on a non-zero return."""
    R, B, Hq, _, hd = o_parts.shape
    o_parts, lse_parts = o_parts.contiguous(), lse_parts.contiguous()
    out = torch.empty((B, 1, Hq, hd), dtype=dtype,
                      device=o_parts.device).transpose(1, 2)
    err = lib.flash_decode_merge_launch(
        o_parts.data_ptr(), lse_parts.data_ptr(), out.data_ptr(),
        _DTYPE[dtype], R, B, Hq, hd, out.stride(0), out.stride(1), stream)
    build.check(err, "decode_merge")
    return out


# launches on the card
decode_merge.launches = 0
