"""Device times of the port's attention shapes by named row set, written
to a file so that two checkouts of the port can be timed in one call.

    python3 tools/prefill_times.py --src OLD/src --out old.json [--rows hd288]
    python3 tools/prefill_times.py --out new.json --compare old.json

Times (``repro_torch.obs.profile.graph_ms``: a CUDA graph of ``iters``
calls replayed 3 times, CUDA events, the mean a call)
``flash_attention`` and ``flash_decode_q8`` through their public
wrappers at the shapes ``chip_smoke.py`` serves, each beside one
``scaled_dot_product_attention`` call on the same operands where SDPA
computes the same function (``is_causal`` where the causal mask is all
of it, a bool mask where a window or ``kv_valid`` bites, no mask for
the non-causal ones; none with a softcap or an int8 cache).  The row
sets (``--rows``, comma-separated; default ``prefill``):

* ``prefill``: the hd 64/120/128 prefill of llama3.2-1b, hymba-1.5b
  (B=16, L=512 and B=4, L=4,608), h2o-danube-3-4b (hd 120, the same
  two), seamless-m4t-medium (its encoder, decoder and cross prefills),
  llava-next-mistral-7b (2,880 patches + 512 tokens) and qwen2-1.5b;
  the seamless cross decode (16 keys, every key live) and qwen2-1.5b's
  decode (B=16, 536 slots, live 513-528);
* ``hd288``: gemma2-2b's head dim 288 (softcap 50): the decode of the
  bf16 and int8 caches at B=16 over 536 slots (the local window of
  4,096 and global), over a full ring of 4,096 at B=4 (``long_mode``)
  and at B=1 (the long_500k step, also with ``return_lse``); the
  prefill at B=16, L=512 and B=4, L=4,608, local and global.

Inputs are seeded bf16 normals, the same in every checkout.  Each
decode's output is written whole, each prefill's as two checksums and
its first sequence's first two heads (``--out`` with ``.npz`` beside
the JSON); ``--compare`` prints, per row, the ratio of the times and
whether the outputs are the same bits as the other file's (else the
largest difference of the kept slice).  The kernels each decode
launches a call are read from a profiler trace
(``repro_torch.obs.profile.kernel_trace``).  ``--src`` is the ``src``
directory whose ``repro_torch`` is imported (default: this
checkout's).  Needs one CUDA card."""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

# (name, heads, kv heads, hd, window) of the served configs
CFG = {"llama3.2-1b": (32, 8, 64, 0), "hymba-1.5b": (25, 5, 64, 1024),
       "h2o-danube-3-4b": (32, 8, 120, 4096),
       "seamless-m4t-medium": (16, 16, 64, 0),
       "llava-next-mistral-7b": (32, 8, 128, 0),
       "qwen2-1.5b": (12, 2, 128, 0), "gemma2-2b": (8, 4, 288, 4096)}
CAP = 50.0                                      # gemma2-2b's softcap


def launched(kernel_trace, fn) -> str:
    """The kernels one ``fn()`` launches, by name, from a profiler trace
    of 10 calls."""
    names = {}
    for key, (_, n) in kernel_trace(fn, calls=10, warmup=1).items():
        m = re.search(r"\w+_kernel\b", key)
        name = m.group() if m else key[:60]
        names[name] = names.get(name, 0) + n
    return ", ".join(f"{k} x{v:g}" for k, v in names.items()) or \
        "no device time in the trace"


def sdpa_mask(torch, dev, Lq, Lk, causal, window, kvt):
    """SDPA's mask arguments for flash_attention's causal / window /
    kv_valid on these lengths."""
    ik = torch.arange(Lk, device=dev)
    if kvt is not None:
        return dict(attn_mask=(ik[None, :] < kvt[:, None])[:, None, None, :])
    if not causal:
        return {}
    if window and window < Lk:
        row = torch.arange(Lq, device=dev)[:, None] + Lk - Lq
        return dict(attn_mask=(ik[None] <= row) & (ik[None] > row - window))
    return dict(is_causal=True)


def prefill_rows(torch, FA):
    """(name, kernel fn, SDPA fn or None, iters) of the ``prefill`` set,
    inputs seeded per row."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    out = []

    def add(name, B, Lq, Lk, arch, causal, kv=None, iters=20):
        Hq, Hkv, hd, W = CFG[arch]
        g = torch.Generator(device=dev).manual_seed(B * 131 + Lq + Lk + hd)
        q, k, v = (torch.randn(B, n, H, hd, generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2)
                   for n, H in ((Lq, Hq), (Lk, Hkv), (Lk, Hkv)))
        kvt = None if kv is None else torch.tensor(kv, dtype=torch.int32,
                                                   device=dev)
        win = W if causal else 0
        kw = dict(causal=causal, window=win)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        mask = sdpa_mask(torch, dev, Lq, Lk, causal, win, kvt)
        out.append((name,
                    lambda: FA.flash_attention(q, k, v, kvt, **kw),
                    lambda: F.scaled_dot_product_attention(
                        qc, kc, vc, enable_gqa=True, **mask), iters))
    add("llama3.2-1b prefill B=16 L=512", 16, 512, 512, "llama3.2-1b", True)
    add("hymba-1.5b prefill B=16 L=512", 16, 512, 512, "hymba-1.5b", True)
    add("hymba-1.5b prefill B=4 L=4608 window 1024", 4, 4608, 4608,
        "hymba-1.5b", True, iters=5)
    add("h2o-danube-3-4b prefill B=16 L=512 (hd 120)", 16, 512, 512,
        "h2o-danube-3-4b", True)
    add("h2o-danube-3-4b prefill B=4 L=4608 window 4096 (hd 120)", 4, 4608,
        4608, "h2o-danube-3-4b", True, iters=5)
    add("seamless-m4t-medium encoder B=16 16x16", 16, 16, 16,
        "seamless-m4t-medium", False)
    add("seamless-m4t-medium decoder prefill B=16 L=512", 16, 512, 512,
        "seamless-m4t-medium", True)
    add("seamless-m4t-medium cross prefill B=16 512x16", 16, 512, 16,
        "seamless-m4t-medium", False)
    add("llava-next-mistral-7b prefill B=16 L=3392", 16, 3392, 3392,
        "llava-next-mistral-7b", True, iters=3)
    add("qwen2-1.5b prefill B=16 L=512", 16, 512, 512, "qwen2-1.5b", True)
    add("decode seamless-m4t-medium cross B=16 16 keys", 16, 1, 16,
        "seamless-m4t-medium", False)
    add("decode qwen2-1.5b B=16 536 slots", 16, 1, 536, "qwen2-1.5b", False,
        kv=[513 + (i * 5) % 16 for i in range(16)])
    return out


def hd288_rows(torch, FA):
    """(name, kernel fn, None, iters) of the ``hd288`` set (gemma2-2b's
    softcap: no SDPA call computes it), inputs seeded per row."""
    from repro_torch.models.layers import quantize_kv

    dev = torch.device("cuda", 0)
    Hq, Hkv, hd, W = CFG["gemma2-2b"]

    def rn(g, *shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)
    out = []
    for B, C, live, tag in ((16, 536, None, "served B=16, 536 slots"),
                            (4, 4096, 4096, "long_mode ring B=4"),
                            (1, 4096, 4096, "long_500k B=1")):
        g = torch.Generator(device=dev).manual_seed(B * 7 + C)
        q = rn(g, B, 1, Hq, hd).transpose(1, 2)
        k = rn(g, B, C, Hkv, hd).transpose(1, 2)
        v = rn(g, B, C, Hkv, hd).transpose(1, 2)
        kv = (torch.arange(B, device=dev, dtype=torch.int32) % 16 + C - 23
              if live is None else
              torch.full((B,), live, device=dev, dtype=torch.int32))
        (k8, ks), (v8, vs) = (quantize_kv(t.transpose(1, 2).float())
                              for t in (k, v))
        q8 = [t.transpose(1, 2) for t in (k8, v8, ks, vs)]
        iters = 20 if C < 1000 else 10
        for loc in ((W, 0) if live is None else (0,)):
            kw = dict(softcap=CAP, local_window=loc)
            mask = "local 4096" if loc else "global"
            out.append((f"decode bf16 {tag} {mask}",
                        lambda q=q, k=k, v=v, kv=kv, kw=kw:
                        FA.flash_attention(q, k, v, kv, causal=False, **kw),
                        None, iters))
            out.append((f"decode int8 {tag} {mask}",
                        lambda q=q, a=q8, kv=kv, kw=kw:
                        FA.flash_decode_q8(q, *a, kv, **kw), None, iters))
        if B == 1:
            out.append((f"decode bf16 {tag} with lse",
                        lambda q=q, k=k, v=v, kv=kv:
                        FA.flash_attention(q, k, v, kv, causal=False,
                                           softcap=CAP, return_lse=True)[0],
                        None, 10))
            out.append((f"decode int8 {tag} with lse",
                        lambda q=q, a=q8, kv=kv:
                        FA.flash_decode_q8(q, *a, kv, softcap=CAP,
                                           return_lse=True)[0], None, 10))
    for B, L in ((16, 512), (4, 4608)):
        g = torch.Generator(device=dev).manual_seed(B + L)
        q = rn(g, B, L, Hq, hd).transpose(1, 2)
        k = rn(g, B, L, Hkv, hd).transpose(1, 2)
        v = rn(g, B, L, Hkv, hd).transpose(1, 2)
        for win, mask in ((W, "local 4096"), (0, "global")):
            out.append((f"prefill B={B} L={L} {mask}",
                        lambda q=q, k=k, v=v, win=win:
                        FA.flash_attention(q, k, v, causal=True, window=win,
                                           softcap=CAP),
                        None, 20 if L < 1000 else 4))
    return out


ROW_SETS = {"prefill": prefill_rows, "hd288": hd288_rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--out", required=True, help="a .json path")
    ap.add_argument("--compare", default=None)
    ap.add_argument("--rows", default="prefill",
                    help=f"comma-separated row sets of {sorted(ROW_SETS)}")
    args = ap.parse_args()
    sets = args.rows.split(",")
    if not set(sets) <= set(ROW_SETS):
        ap.error(f"--rows: {args.rows} (sets: {sorted(ROW_SETS)})")
    # this checkout's readings (--src may name a checkout without them),
    # then the timed checkout's repro_torch, imported afresh
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.obs.profile import graph_ms, kernel_trace
    for m in [m for m in sys.modules if m.partition(".")[0] == "repro_torch"]:
        del sys.modules[m]
    sys.path[0] = str(Path(args.src).resolve())
    import torch
    if not torch.cuda.is_available():
        print("prefill_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as FA
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"repro_torch from {Path(FA.__file__).parents[1]}; {card}",
          flush=True)
    res, outs = {}, {}
    for name, fn, sdpa, iters in (r for x in sets
                                  for r in ROW_SETS[x](torch, FA)):
        o = fn()
        if name.startswith("decode"):
            outs[name] = o.float().cpu().numpy()
        else:          # 10-450 MB: two checksums and a slice stand for it
            outs[name] = o[0, :2].float().cpu().numpy()
            outs[name + " sums"] = np.array([o.double().sum().item(),
                                             o.double().abs().sum().item()])
        del o
        ms = graph_ms(fn, iters)
        lib = None if sdpa is None else graph_ms(sdpa, iters)
        res[name] = dict(ms=ms, sdpa_ms=lib)
        extra = f"; launches {launched(kernel_trace, fn)}" \
            if name.startswith("decode") else ""
        vs = "no SDPA call" if lib is None else \
            f"SDPA {lib:.4f} ms ({ms / lib:.2f}x)"
        print(f"{name}: {ms:.4f} ms, {vs}{extra}", flush=True)
        torch.cuda.empty_cache()
    Path(args.out).write_text(json.dumps(dict(card=card, rows=res),
                                         indent=1))
    np.savez(Path(args.out).with_suffix(".npz"), **outs)
    if args.compare:
        other = json.loads(Path(args.compare).read_text())["rows"]
        theirs = np.load(Path(args.compare).with_suffix(".npz"))
        for name, r in res.items():
            same = np.array_equal(theirs[name], outs[name]) and (
                name.startswith("decode") or np.array_equal(
                    theirs[name + " sums"], outs[name + " sums"]))
            diff = "the same bits" if same else (
                "differs, max |diff| of the kept slice "
                f"{float(np.abs(theirs[name] - outs[name]).max()):.3g}")
            print(f"{name}: {r['ms']:.4f} ms against "
                  f"{other[name]['ms']:.4f} ({r['ms'] / other[name]['ms']:.3f}x);"
                  f" output {diff}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
