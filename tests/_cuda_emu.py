"""Run a kernel source of ``src/repro_torch/kernels/csrc`` on the CPU.

There is no card and no nvcc on a CPU-only machine, so a kernel is
otherwise first run on the card.  This compiles ``csrc/<name>.cu`` with
g++ against ``emu.h`` (a CPU model of blocks, threads, warps and shared
memory) and ``prims.h`` (cp.async, ldmatrix, mma.sync and wgmma as
warp collectives, mbarriers as fiber waits, TMA boxes as swizzled
copies) into a shared library with the same C entry points, and
loads it with ctypes.  The wrappers' launch helpers take any ctypes
handle, so CPU tensors can go through the kernel's own code path, e.g.
``ssd_scan._bwd_launch(lib, None, x, dt, A, B, C, dy, dh)``
(``tests/test_torch_cuda_emu.py``).

It checks arithmetic, indexing, masking and the order of barriers; it
says nothing of speed, occupancy or what the real compiler accepts.
Emulated blocks run one after another, so a kernel whose blocks wait on
one another (a ticket that only orders them is fine) would hang.

    python tests/_cuda_emu.py ssd_scan_bwd --shape 2,150,4,64,128 \\
        --dtype f32 --dh --seed 3

compares the scan's backward with its plain version (and both with an
f64 run of the plain version) at that shape: each gradient's max error
over its max |g|;

    python tests/_cuda_emu.py flash_attention_bwd --shape 1,4,2,150,150,128 \
        --window 64

does the same for the attention backward (the body ``bwd_body`` names:
wgmma's TMA boxes, mbarriers and ``wgmma`` are emulated too);

    python tests/_cuda_emu.py moe_gating_bwd --shape 19,160,8 --dtype bf16

for the gate's backward (a warp a row), and

    python tests/_cuda_emu.py flash_decode_q8 --shape 2,8,2,300,288 \
        --kv 300,150 --softcap 50 --local 100

for the int8 KV decode (the body ``q8_body`` names).  Small shapes: a
block of 256 fibers is slow.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "cuda_emu"
# CUDA code reads registers through other types (bf16 pairs as words):
# no strict aliasing
GXX = ("g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-w", "-Wno-psabi",
       "-fno-strict-aliasing")
PRIMS = ("cp16", "cp_commit", "cp_wait", "mma", "ldsm4", "ldsm4_t",
         "mma16816", "cp_async16", "cp_async8", "cp_async4",
         "cp_async_commit", "cp_async_wait1", "bmul2",
         "ex2", "mbar_init", "mbar_expect_tx", "mbar_arrive", "global_ns",
         "mbar_wait", "tma_box4", "wg_fence", "wg_commit", "wg_wait0",
         "wg_wait1", "rcp", "reg_fence", "reg_alloc", "reg_dealloc",
         "wgmma_ss_n32", "wgmma_ss_n64", "wgmma_ss_n128", "wgmma_rs_n64",
         "wgmma_rs_n96", "wgmma_rs_n128", "tma_store4", "bar_sync",
         "bar_arrive")


def _drop(src: str, name: str) -> str:
    """``src`` without the definition of function ``name`` (and its
    template line)."""
    m = re.search(r"__device__ __forceinline__ \w+ " + name + r"\(", src)
    a = m.start()
    line = src.rfind("\n", 0, a - 1)
    if src[line + 1:a].startswith("template"):
        a = line + 1
    q, depth = src.index("{", a), 0
    while True:
        depth += {"{": 1, "}": -1}.get(src[q], 0)
        if depth == 0:
            return src[:a] + src[q + 1:]
        q += 1


def _launches(src: str) -> str:
    """``k<<<g, b, smem, s>>>(args);`` -> ``emu::launch(g, b, smem,
    [&] { k(args); });``"""
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        k, depth = j, 0                 # the kernel's name, back to the
        while k > 0:                    # start of its statement
            depth += {">": 1, "<": -1}.get(src[k - 1], 0)
            if depth == 0 and src[k - 1] in ";{}\n":
                break
            k -= 1
        name = src[k:j].strip()
        e = src.index(">>>", j)
        cfg, parts, depth, cur = src[j + 3:e], [], 0, ""
        for ch in cfg:
            depth += {"(": 1, "<": 1, ")": -1, ">": -1}.get(ch, 0)
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        parts.append(cur)
        p = src.index("(", e)
        q, depth = p, 0
        while True:
            depth += {"(": 1, ")": -1}.get(src[q], 0)
            if depth == 0:
                break
            q += 1
        out.append(src[i:k] + f"emu::launch(dim3({parts[0]}), "
                   f"dim3({parts[1]}), (long long)({parts[2]}), [&] {{ "
                   f"{name}({src[p + 1:q]}); }})")
        i = q + 1
    return "".join(out) + src[i:]


def source(name: str) -> str:
    """``csrc/<name>.cu`` rewritten for the emulation."""
    seen = set()

    def inline(m):                      # each header once, nested too
        if m.group(1) in seen:
            return ""
        seen.add(m.group(1))
        return re.sub(r'#include "([^"]+)"', inline,
                      (CSRC / m.group(1)).read_text())
    src = re.sub(r'#include "([^"]+)"', inline,
                 (CSRC / f"{name}.cu").read_text())
    src = src.replace("#include <cuda_bf16.h>", '#include "emu.h"')
    for h in ("cuda_runtime.h", "cuda.h", "math_constants.h"):
        src = src.replace(f"#include <{h}>", "")
    for fn in PRIMS:
        if re.search(r"__device__ __forceinline__ \w+ " + fn + r"\(", src):
            src = _drop(src, fn)
    # the asm statements left in kernel bodies (fences, cp.async waits)
    src = re.sub(r'asm volatile\("[^"]*"\s*:::\s*"memory"\);', "", src)
    first = src.index("__device__ __forceinline__")
    src = src[:first] + '#include "prims.h"\n' + src[first:]
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+(?: \w+)?) "
                 r"(\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu::smem_base());", src)
    return _launches(src)


def build(name: str) -> Path:
    """Compile the emulation of ``csrc/<name>.cu`` (cached by content)."""
    src = source(name)
    extra = "".join((HERE / f).read_text() for f in ("emu.h", "prims.h"))
    tag = hashlib.sha256((src + extra + " ".join(GXX)).encode()).hexdigest()[:12]
    lib = OUT / f"lib{name}-emu-{tag}.so"
    if not lib.exists():
        OUT.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cpp = tmp.with_suffix(".cpp")
        cpp.write_text(src)
        subprocess.run([*GXX, f"-I{HERE}", "-o", str(tmp), str(cpp)],
                       check=True)
        cpp.unlink()
        os.replace(tmp, lib)
    return lib


def load(name: str, signatures) -> ctypes.CDLL:
    """The ctypes handle of the emulation, entry points typed as the
    wrapper's (``signatures``: name -> argtypes, returning int)."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def scan_inputs(shape, dtype, with_dh: bool, seed: int):
    """The scan backward's operands as the model hands them over: x, B
    and C strided views of one projection (``dtype``), dt in [0, 0.2),
    A from -1 to -16, dy and (``with_dh``) the final state's gradient."""
    import torch

    Bb, L, H, P, N = shape
    g = torch.Generator().manual_seed(seed)
    xbc = torch.randn(Bb, L, H * P + 2 * N, generator=g).to(dtype)
    return (xbc[..., :H * P].unflatten(-1, (H, P)),
            torch.rand(Bb, L, H, generator=g) * 0.2,
            -torch.linspace(1.0, 16.0, H), xbc[..., H * P:H * P + N],
            xbc[..., H * P + N:], torch.randn(Bb, L, H, P, generator=g),
            torch.randn(Bb, H, P, N, generator=g) if with_dh else None)


def check_ssd_scan_bwd(shape, dtype: str, with_dh: bool, seed: int):
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ssd_scan as SS

    lib = load("ssd_scan", SS._SIG)
    dt_ = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    args = scan_inputs(shape, dt_, with_dh, seed)
    got = SS._bwd_launch(lib, None, *args)
    again = SS._bwd_launch(lib, None, *args)
    want = SS.ssd_scan_bwd_plain(*args)
    f64 = SS.ssd_scan_bwd_plain(*(None if a is None else a.double()
                                  for a in args))
    for nm, a, b, r in zip(("dx", "ddt", "dA", "dB", "dC"), got, want, f64):
        m = float(b.float().abs().max())
        print(f"{nm}: kernel {float((a.float() - b.float()).abs().max()) / m:.3g}"
              f" of max |g| against the plain version; against f64: kernel "
              f"{float((a.double() - r).abs().max()) / m:.3g}, plain "
              f"{float((b.double() - r).abs().max()) / m:.3g}")
    print("two launches:", "the same bits" if all(
        torch.equal(a, b) for a, b in zip(got, again)) else "DIFFER")


def attn_inputs(B, Hq, Hkv, L, Lk, hd, dtype, layout: str, seed: int):
    """q, k, v, do of the attention backward (B, H, L, hd): "blhd"
    ``transpose(1, 2)`` views of the model's (B, L, H, hd) layout,
    "bhld" contiguous tensors, "pad" views whose rows lie 8 bytes off
    16."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def one(Lx, H):
        if layout == "bhld":
            return torch.randn(B, H, Lx, hd, generator=g).to(dtype)
        w = H * hd + (4 if layout == "pad" else 0)
        x = torch.randn(B, Lx, w, generator=g).to(dtype)
        return x[..., :H * hd].unflatten(-1, (H, hd)).transpose(1, 2)
    q, k, v, do = one(L, Hq), one(Lk, Hkv), one(Lk, Hkv), one(L, Hq)
    return q, k, v, do


def attn_bwd(lib, q, k, v, do, kv_valid, causal, window, softcap):
    """The backward of ``csrc/flash_attention_bwd.cuh`` through ``lib``
    (the body ``bwd_body`` names), fed the plain forward's o and lse;
    returns (gradients, the plain backward's, the body)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as FA

    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = FA.flash_attention_plain(q, k, v, kv_valid, return_lse=True,
                                      **kw)
    body = FA.bwd_body(q, k, v, do)
    got = FA._bwd_launch(lib, None, q, k, v, o, lse, do, kv_valid, causal,
                         window, softcap, body)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, kv_valid, **kw)
    return got, want, body


def check_flash_attention_bwd(shape, dtype: str, layout: str, causal: bool,
                              window: int, softcap: float, seed: int):
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as FA

    lib = load("flash_attention", FA._SIG)
    dt_ = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    args = attn_inputs(*shape, dt_, layout, seed)
    got, want, body = attn_bwd(lib, *args, None, causal, window, softcap)
    again, _, _ = attn_bwd(lib, *args, None, causal, window, softcap)
    print(f"{body} body")
    for nm, a, b in zip(("dq", "dk", "dv"), got, want):
        m = float(b.float().abs().max())
        print(f"{nm}: kernel {float((a.float() - b.float()).abs().max()) / m:.3g}"
              f" of max |g| against the plain version")
    print("two launches:", "the same bits" if all(
        torch.equal(a, b) for a, b in zip(got, again)) else "DIFFER")


def q8_inputs(B, Hq, Hkv, C, hd, dtype, seed: int):
    """An int8 decode's operands as the model hands them over: q (B, Hq,
    1, hd) in ``dtype`` and the int8 cache (B, C, Hkv, hd) with its f32
    scales (``quantize_kv`` of seeded rows, K twice V's spread), all
    ``transpose(1, 2)`` views."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models.layers import quantize_kv

    g = torch.Generator().manual_seed(seed)
    k8, ks = quantize_kv(torch.randn(B, C, Hkv, hd, generator=g) * 2)
    v8, vs = quantize_kv(torch.randn(B, C, Hkv, hd, generator=g))
    q = torch.randn(B, 1, Hq, hd, generator=g).to(dtype)
    return [x.transpose(1, 2) for x in (q, k8, v8, ks, vs)]


def q8_decode(lib, q, k8, v8, ks, vs, kv_valid, softcap, local_window):
    """The int8 decode of ``csrc/flash_attention.cu`` through ``lib`` (the
    body ``q8_body`` names); returns (output, the plain version's, the
    body)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as FA

    body = FA.q8_body(q, k8)
    got = FA._q8_launch(lib, None, q, k8, v8, ks, vs, kv_valid, softcap,
                        local_window, body)
    want = FA.decode_q8_plain(q, k8, v8, ks, vs, kv_valid, softcap=softcap,
                              local_window=local_window)
    return got, want, body


def check_flash_decode_q8(shape, dtype: str, kv: str, softcap: float,
                          local: int, seed: int):
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as FA

    lib = load("flash_attention", FA._SIG)
    B, Hq, Hkv, C, hd = shape
    args = q8_inputs(B, Hq, Hkv, C, hd, {"f32": torch.float32,
                                         "bf16": torch.bfloat16}[dtype], seed)
    kvt = None if not kv else torch.tensor(
        [int(x) for x in kv.split(",")], dtype=torch.int32)
    got, want, body = q8_decode(lib, *args, kvt, softcap, local)
    again, _, _ = q8_decode(lib, *args, kvt, softcap, local)
    print(f"{body} body, splits {FA.q8_splits(B, Hkv, C, hd, body)}")
    print(f"out: max err {float((got.float() - want.float()).abs().max()):.3g}"
          f" (max |want| {float(want.float().abs().max()):.3g})")
    print("two launches:", "the same bits" if torch.equal(got, again)
          else "DIFFER")


def gate_inputs(T: int, E: int, k: int, dtype, seed: int):
    """The gate backward's operands as training hands them over: logits
    (T, E) in ``dtype`` (two rows with 16 tied experts), the plain
    forward's idx and asum, dvals and daux."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import moe_gating as MG

    g = torch.Generator().manual_seed(seed)
    lg = (torch.randn(T, E, generator=g) * 2).to(dtype)
    lg[:2, :16] = 0.5
    _, idx, _, asum = MG.moe_gating_plain(lg, k, True)
    return (lg, idx, torch.randn(T, k, generator=g), torch.tensor(0.37),
            asum)


def check_moe_gating_bwd(T: int, E: int, k: int, dtype: str, seed: int):
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import moe_gating as MG

    lib = load("moe_gating", MG._SIG)
    args = gate_inputs(T, E, k, {"f32": torch.float32,
                                 "bf16": torch.bfloat16}[dtype], seed)
    got = MG._bwd_launch(lib, None, *args)
    want = MG.moe_gating_bwd_plain(*args)
    m = float(want.float().abs().max())
    print(f"dlogits: kernel {float((got.float() - want.float()).abs().max()) / m:.3g}"
          f" of max |g| against the plain version")
    print("two launches:", "the same bits" if torch.equal(
        got, MG._bwd_launch(lib, None, *args)) else "DIFFER")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=["ssd_scan_bwd", "flash_attention_bwd",
                                       "moe_gating_bwd", "flash_decode_q8"])
    ap.add_argument("--shape", default=None,
                    help="Bb,L,H,P,N (ssd_scan_bwd, default 2,150,4,64,128)"
                         " or B,Hq,Hkv,L,Lk,hd (flash_attention_bwd, "
                         "default 1,4,2,150,150,64), T,E,k "
                         "(moe_gating_bwd, default 19,128,8) or "
                         "B,Hq,Hkv,C,hd (flash_decode_q8, default "
                         "2,8,2,300,64)")
    ap.add_argument("--dtype", choices=["f32", "bf16"], default=None,
                    help="default f32 for the scan, bf16 for attention")
    ap.add_argument("--dh", action="store_true",
                    help="give the final state a gradient (the scan)")
    ap.add_argument("--layout", choices=["blhd", "bhld", "pad"],
                    default="blhd", help="attention operands' layout")
    ap.add_argument("--no-causal", action="store_true")
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--softcap", type=float, default=0.0)
    ap.add_argument("--local", type=int, default=0,
                    help="the int8 decode's window ending at kv_valid")
    ap.add_argument("--kv", default="",
                    help="the int8 decode's kv_valid, comma-separated")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    if a.kernel == "ssd_scan_bwd":
        check_ssd_scan_bwd(tuple(int(v) for v in (
            a.shape or "2,150,4,64,128").split(",")), a.dtype or "f32",
            a.dh, a.seed)
    elif a.kernel == "flash_decode_q8":
        check_flash_decode_q8(tuple(int(v) for v in (
            a.shape or "2,8,2,300,64").split(",")), a.dtype or "bf16", a.kv,
            a.softcap, a.local, a.seed)
    elif a.kernel == "moe_gating_bwd":
        check_moe_gating_bwd(*(int(v) for v in (
            a.shape or "19,128,8").split(",")), a.dtype or "f32", a.seed)
    else:
        check_flash_attention_bwd(tuple(int(v) for v in (
            a.shape or "1,4,2,150,150,64").split(",")), a.dtype or "bf16",
            a.layout, not a.no_causal, a.window, a.softcap, a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
