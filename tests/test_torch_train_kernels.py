"""The backward of the three kernels a training step runs, on the CPU:
each plain backward (``flash_attention_bwd_plain``, ``ssd_scan_bwd_plain``,
``moe_gating_bwd_plain``) against (a) ``torch.autograd`` through the
plain forward and (b) ``jax.grad`` through the reference's oracle
(``ref.mha_attention``, ``ref.ssd_scan``, ``ref.moe_gating``) on the
same numpy inputs; ``torch.autograd.gradcheck`` on each
``autograd.Function`` of ``kernels/ops`` in f64 (its fast mode: a
random projection of the Jacobian, against the numeric one); and the
ops' paths:
no autograd Function under ``no_grad``, the decode shapes refusing a
gradient.

Tolerances: 2e-5 of each gradient's max |g| in f32 (the same products
summed in another order, a few hundred terms deep; 5e-5 for the scan,
whose chunked form and the oracle's sequential scan differ in the
order of their exponentials); gradcheck's defaults in f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import moe_gating as MG
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SS


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: its many small ops
    slow down by an order of magnitude when every test worker's pool
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3g} of max |g| > {tol}"


def t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------

ATTN = [  # B, Hq, Hkv, Lq, Lk, hd, causal, window, softcap
    (2, 4, 1, 33, 33, 64, True, 0, 0.0),       # GQA 4, causal
    (1, 4, 2, 40, 40, 64, True, 12, 0.0),      # sliding window
    (1, 2, 2, 24, 24, 64, True, 0, 50.0),      # softcap
    (2, 4, 2, 17, 9, 64, False, 0, 0.0),       # cross: Lq != Lk
    (1, 3, 1, 21, 21, 120, True, 0, 0.0),      # h2o-danube's head dim
    (1, 2, 1, 20, 20, 288, True, 8, 30.0),     # gemma2's, window + cap
]


def attn_inputs(B, Hq, Hkv, Lq, Lk, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Lk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Lk, Hkv, hd)).astype(np.float32)
    do = rng.standard_normal((B, Lq, Hq, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", ATTN)
def test_flash_attention_bwd_plain(case):
    B, Hq, Hkv, Lq, Lk, hd, causal, window, cap = case
    q, k, v, do = attn_inputs(B, Hq, Hkv, Lq, Lk, hd)
    kw = dict(causal=causal, window=window, softcap=cap)
    # the kernel layout (B, H, L, hd)
    tq, tk, tv, tdo = (t(a).transpose(1, 2) for a in (q, k, v, do))
    o, lse = FA.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = FA.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    # (a) autograd through the plain forward
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = FA.flash_attention_plain(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, tdo)
    for g, w, nm in zip(got, want, "qkv"):
        close(g.numpy(), w.numpy(), 2e-5, f"d{nm} vs autograd")
    # (b) jax.grad through the oracle, layer layout (B, L, H, hd)
    def f(q_, k_, v_):
        return jnp.sum(R.mha_attention(q_, k_, v_, **kw) * do)
    jg = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for g, w, nm in zip(got, jg, "qkv"):
        close(g.transpose(1, 2).numpy(), np.asarray(w), 2e-5,
              f"d{nm} vs jax.grad")


def test_flash_attention_lse_and_empty_rows():
    """The forward's log-sum-exp is logsumexp of the masked scores; a row
    with no live key (kv_valid 0) has lse +inf, output 0 and zero
    gradients."""
    q, k, v, do = attn_inputs(2, 2, 1, 6, 6, 32)
    tq, tk, tv, tdo = (t(a).transpose(1, 2) for a in (q, k, v, do))
    kvv = torch.tensor([6, 0], dtype=torch.int32)
    o, lse = FA.flash_attention_plain(tq, tk, tv, kvv, causal=False,
                                      return_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", tq, tk.expand(2, 2, 6, 32)) / 32 ** .5
    np.testing.assert_allclose(lse[0].numpy(),
                               torch.logsumexp(s[0], -1).numpy(), rtol=1e-6)
    assert torch.isinf(lse[1]).all() and not o[1].any()
    grads = FA.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, kvv,
                                         causal=False)
    assert not grads[0][1].any() and not grads[1][1].any()


# ----------------------------------------------------------------------
# SSD scan
# ----------------------------------------------------------------------

SCAN = [  # Bb, L, H, P, N, dh
    (2, 70, 2, 8, 4, False),      # ragged last chunk (70 = 64 + 6)
    (1, 130, 3, 16, 12, True),    # three chunks, the final state's grad
    (2, 16, 2, 32, 16, False),    # shorter than one chunk
    (1, 150, 2, 64, 128, True),   # mamba2's tile widths, ragged, dh
]


@pytest.mark.parametrize("case", SCAN)
def test_ssd_scan_bwd_plain(case):
    Bb, L, H, P, N, with_dh = case
    rng = np.random.default_rng(1)
    x = rng.standard_normal((Bb, L, H, P)).astype(np.float32)
    dt = (rng.random((Bb, L, H)) * 0.5).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm = rng.standard_normal((Bb, L, N)).astype(np.float32)
    Cm = rng.standard_normal((Bb, L, N)).astype(np.float32)
    dy = rng.standard_normal((Bb, L, H, P)).astype(np.float32)
    dh = rng.standard_normal((Bb, H, P, N)).astype(np.float32) \
        if with_dh else None
    got = SS.ssd_scan_bwd_plain(t(x), t(dt), t(A), t(Bm), t(Cm), t(dy),
                                None if dh is None else t(dh))
    names = ("dx", "ddt", "dA", "dB", "dC")
    leaves = [t(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    y, hf = SS.ssd_scan_plain(*leaves, chunk=16)
    loss = (y * t(dy)).sum() + ((hf * t(dh)).sum() if dh is not None else 0)
    for g, w, nm in zip(got, torch.autograd.grad(loss, leaves), names):
        close(g.numpy(), w.numpy(), 5e-5, f"{nm} vs autograd")

    def f(*args):
        y_, hf_ = R.ssd_scan(*args)
        out = jnp.sum(y_ * dy)
        return out + jnp.sum(hf_ * dh) if dh is not None else out
    jg = jax.grad(f, argnums=(0, 1, 2, 3, 4))(x, dt, A, Bm, Cm)
    for g, w, nm in zip(got, jg, names):
        close(g.numpy(), np.asarray(w), 5e-5, f"{nm} vs jax.grad")


# ----------------------------------------------------------------------
# MoE gate
# ----------------------------------------------------------------------

@pytest.mark.parametrize("T,E,k", [(40, 16, 2), (9, 128, 8), (12, 8, 1)])
def test_moe_gating_bwd_plain(T, E, k):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[0, :4] = 0.5                  # tied probabilities
    logits[1, 3:9] = 2.0
    dv = rng.standard_normal((T, k)).astype(np.float32)
    da = np.float32(0.7)
    vals, idx, aux, asum = MG.moe_gating_plain(t(logits), k, True)
    got = MG.moe_gating_bwd_plain(t(logits), idx, t(dv), torch.tensor(da),
                                  asum)
    leaf = t(logits).requires_grad_()
    v2, _, a2 = MG.moe_gating_plain(leaf, k)
    want, = torch.autograd.grad((v2 * t(dv)).sum() + da * a2, leaf)
    close(got.numpy(), want.numpy(), 2e-5, "vs autograd")

    def f(lg):
        v_, _, a_ = R.moe_gating(lg, k)
        return jnp.sum(v_ * dv) + da * a_
    close(got.numpy(), np.asarray(jax.grad(f)(logits)), 2e-5, "vs jax.grad")
    # the oracle's ties: the same experts, in the same order
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(R.moe_gating(logits, k)[1]))


def test_moe_gating_plain_takes_given_experts():
    """A given idx stands in for the top-k: the gate's own choice gives
    the same outputs as no idx; another choice gives those experts'
    renormalised probabilities, their counts and the aux over them."""
    rng = np.random.default_rng(4)
    T, E, k = 10, 16, 3
    logits = t(rng.standard_normal((T, E)).astype(np.float32))
    own = MG.moe_gating_plain(logits, k, True)
    same = MG.moe_gating_plain(logits, k, True, idx=own[1])
    for a, b in zip(own, same):
        assert torch.equal(a, b)
    idx = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                     for _ in range(T)]).astype(np.int32))
    vals, idx2, aux, asum = MG.moe_gating_plain(logits, k, True, idx=idx)
    p = torch.softmax(logits, dim=-1)
    r = p.gather(1, idx.long())
    close(vals.numpy(), (r / (r.sum(-1, keepdim=True) + 1e-9)).numpy(), 1e-6)
    assert torch.equal(idx2, idx)
    want = torch.bincount(idx.long().flatten(), minlength=E).float()
    assert torch.equal(asum, want)
    close(aux.numpy(), (E * (p.sum(0) / T * want / T).sum()).numpy(), 1e-6)


# ----------------------------------------------------------------------
# the autograd Functions of ops, in f64
# ----------------------------------------------------------------------

def _f64(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()


@pytest.mark.parametrize("kw", [dict(causal=True, window=0, softcap=0.0),
                                dict(causal=True, window=3, softcap=5.0),
                                dict(causal=False, window=0, softcap=0.0)])
def test_gradcheck_flash_attention(kw):
    rng = np.random.default_rng(3)
    q, k, v = _f64(rng, 1, 5, 4, 8), _f64(rng, 1, 5, 2, 8), \
        _f64(rng, 1, 5, 2, 8)
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.flash_attention(a, b, c, **kw), (q, k, v),
        fast_mode=True)


def test_gradcheck_ssd_scan():
    rng = np.random.default_rng(4)
    x = _f64(rng, 1, 70, 2, 3)
    dt = torch.from_numpy(rng.random((1, 70, 2)) * 0.3).requires_grad_()
    A = torch.tensor([-1.0, -2.5], dtype=torch.float64, requires_grad=True)
    Bm, Cm = _f64(rng, 1, 70, 2), _f64(rng, 1, 70, 2)
    assert torch.autograd.gradcheck(
        lambda *a: ops.ssd_scan(*a, chunk=16), (x, dt, A, Bm, Cm),
        fast_mode=True)


def test_gradcheck_moe_gating():
    rng = np.random.default_rng(5)
    logits = _f64(rng, 2, 3, 6)

    def f(lg):
        vals, _, aux = ops.moe_gating(lg, 2)
        return vals, aux
    assert torch.autograd.gradcheck(f, (logits,), fast_mode=True)


def test_ops_take_the_function_only_where_autograd_records(monkeypatch):
    """Under ``no_grad`` (the served path) and with operands that need no
    gradient, the ops call the forward kernels as before and save
    nothing; the decode shapes refuse a gradient."""
    calls = []
    for name in ("_FlashAttention", "_SsdScan", "_MoeGating"):
        fn = getattr(ops, name)
        monkeypatch.setattr(fn, "apply",
                            lambda *a, _n=name, _f=fn.apply: (
                                calls.append(_n), _f(*a))[1])
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 4, 2, 8)).astype(
        np.float32)).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((1, 4, 1, 8)).astype(
        np.float32))
    with torch.no_grad():
        ops.flash_attention(q, k, k)
        ops.moe_gating(q.reshape(4, 16), 2)
    ops.flash_attention(q.detach(), k, k)
    assert calls == []
    ops.flash_attention(q, k, k)
    ops.moe_gating(q.reshape(4, 16), 2)
    assert calls == ["_FlashAttention", "_MoeGating"]
    with pytest.raises(ValueError, match="decode shape"):
        ops.flash_attention(q[:, :1], k, k, causal=False)
    with pytest.raises(ValueError, match="int8"):
        ops.flash_decode(q[:, :1], torch.zeros(1, 4, 1, 8, dtype=torch.int8),
                         torch.zeros(1, 4, 1, 8, dtype=torch.int8),
                         torch.tensor([2]), k_scale=torch.ones(1, 4, 1, 1),
                         v_scale=torch.ones(1, 4, 1, 1))
    with pytest.raises(ValueError, match="h0"):
        ops.ssd_scan(q.reshape(1, 4, 2, 8), torch.ones(1, 4, 2),
                     -torch.ones(2), k[..., 0, :], k[..., 0, :],
                     torch.zeros(1, 2, 8, 8))
