"""Device times of gemma2-2b's head-dim-288 attention shapes, written to
a file so that two checkouts of the port can be timed in one call.

    python3 tools/hd288_times.py --src OLD/src --out old.json
    python3 tools/hd288_times.py --out new.json --compare old.json

Times (a CUDA graph of ``iters`` calls replayed 3 times, CUDA events,
the mean a call) ``flash_attention`` and ``flash_decode_q8`` through
their public wrappers at the shapes ``chip_smoke.py`` serves: the bf16
cache's decode at B=16 over 536 slots (live 513-528, softcap 50, the
local window of 4,096 and global), over a full ring of 4,096 at B=4
(``long_mode``) and at B=1 (the long_500k step), with ``return_lse`` at
B=1; the same three on an int8 cache; the prefill at B=16, L=512 and at
B=4, L=4,608, local and global.  Inputs are seeded bf16 normals, the
same in every checkout.  Each decode row's output is written too
(``--out`` with ``.npz`` beside the JSON; a prefill's two checksums),
and ``--compare`` prints, per row, the ratio of the times and whether
the outputs are the same bits as the other file's.  ``--src`` is the
``src`` directory whose ``repro_torch`` is imported (default: this
checkout's).  Needs one CUDA card."""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HQ, HKV, HD, CAP, W = 8, 4, 288, 50.0, 4096     # gemma2-2b


def graph_ms(torch, fn, iters: int, reps: int = 3) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (iters * reps)


def rows(torch, FA):
    """(name, fn, iters) of every timed shape, inputs seeded per row."""
    from repro_torch.models.layers import quantize_kv

    dev = torch.device("cuda", 0)

    def rn(g, *shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)
    out = []
    for B, C, live, tag in ((16, 536, None, "served B=16, 536 slots"),
                            (4, 4096, 4096, "long_mode ring B=4"),
                            (1, 4096, 4096, "long_500k B=1")):
        g = torch.Generator(device=dev).manual_seed(B * 7 + C)
        q = rn(g, B, 1, HQ, HD).transpose(1, 2)
        k = rn(g, B, C, HKV, HD).transpose(1, 2)
        v = rn(g, B, C, HKV, HD).transpose(1, 2)
        kv = (torch.arange(B, device=dev, dtype=torch.int32) % 16 + C - 23
              if live is None else
              torch.full((B,), live, device=dev, dtype=torch.int32))
        (k8, ks), (v8, vs) = (quantize_kv(t.transpose(1, 2).float())
                              for t in (k, v))
        q8 = [t.transpose(1, 2) for t in (k8, v8, ks, vs)]
        locs = (W, 0) if live is None else (0,)
        for loc in locs:
            kw = dict(softcap=CAP, local_window=loc)
            mask = "local 4096" if loc else "global"
            out.append((f"decode bf16 {tag} {mask}",
                        lambda q=q, k=k, v=v, kv=kv, kw=kw:
                        FA.flash_attention(q, k, v, kv, causal=False, **kw),
                        20 if C < 1000 else 10))
            out.append((f"decode int8 {tag} {mask}",
                        lambda q=q, a=q8, kv=kv, kw=kw:
                        FA.flash_decode_q8(q, *a, kv, **kw),
                        20 if C < 1000 else 10))
        if B == 1:
            out.append((f"decode bf16 {tag} with lse",
                        lambda q=q, k=k, v=v, kv=kv:
                        FA.flash_attention(q, k, v, kv, causal=False,
                                           softcap=CAP, return_lse=True)[0],
                        10))
            out.append((f"decode int8 {tag} with lse",
                        lambda q=q, a=q8, kv=kv:
                        FA.flash_decode_q8(q, *a, kv, softcap=CAP,
                                           return_lse=True)[0], 10))
    for B, L in ((16, 512), (4, 4608)):
        g = torch.Generator(device=dev).manual_seed(B + L)
        q = rn(g, B, L, HQ, HD).transpose(1, 2)
        k = rn(g, B, L, HKV, HD).transpose(1, 2)
        v = rn(g, B, L, HKV, HD).transpose(1, 2)
        for win, mask in ((W, "local 4096"), (0, "global")):
            out.append((f"prefill B={B} L={L} {mask}",
                        lambda q=q, k=k, v=v, win=win:
                        FA.flash_attention(q, k, v, causal=True, window=win,
                                           softcap=CAP),
                        20 if L < 1000 else 4))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--out", required=True, help="a .json path")
    ap.add_argument("--compare", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("hd288_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as FA
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"repro_torch from {Path(FA.__file__).parents[1]}; {card}",
          flush=True)
    res, outs = {}, {}
    for name, fn, iters in rows(torch, FA):
        out = fn()
        # a prefill's output is 10-170 MB: its checksum stands for it
        outs[name] = (out.float().cpu().numpy() if name.startswith("decode")
                      else np.array([out.double().sum().item(),
                                     out.double().abs().sum().item()]))
        res[name] = graph_ms(torch, fn, iters)
        print(f"{name}: {res[name]:.4f} ms", flush=True)
    by_body = getattr(FA.flash_attention, "decode_launches_by_body", None)
    print(f"decode launches by body: {by_body}", flush=True)
    Path(args.out).write_text(json.dumps(dict(card=card, ms=res), indent=1))
    np.savez(Path(args.out).with_suffix(".npz"), **outs)
    if args.compare:
        other = json.loads(Path(args.compare).read_text())["ms"]
        theirs = np.load(Path(args.compare).with_suffix(".npz"))
        for name, ms in res.items():
            same = np.array_equal(theirs[name], outs[name])
            print(f"{name}: {ms:.4f} ms against {other[name]:.4f} "
                  f"({ms / other[name]:.3f}x); output "
                  f"{'the same bits' if same else 'differs'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
