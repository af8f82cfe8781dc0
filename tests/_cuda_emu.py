"""Run a kernel source of ``src/repro_torch/kernels/csrc`` on the CPU.

There is no card and no nvcc on a CPU-only machine, so a kernel is
otherwise first run on the card.  This compiles ``csrc/<name>.cu`` with
g++ against ``emu.h`` (a CPU model of blocks, threads, warps and shared
memory) and ``prims.h`` (cp.async, ldmatrix and mma.sync as warp
collectives) into a shared library with the same C entry points, and
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
over its max |g|.  Small shapes: a block of 256 fibers is slow.
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
PRIMS = ("cp16", "cp_commit", "cp_wait", "mma", "ldsm4", "ldsm4_t")


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
    src = (CSRC / f"{name}.cu").read_text()
    src = re.sub(r'#include "([^"]+)"',
                 lambda m: (CSRC / m.group(1)).read_text(), src)
    src = src.replace("#include <cuda_bf16.h>", '#include "emu.h"')
    src = src.replace("#include <cuda_runtime.h>", "")
    for fn in PRIMS:
        if re.search(r"__device__ __forceinline__ \w+ " + fn + r"\(", src):
            src = _drop(src, fn)
    first = src.index("__device__ __forceinline__")
    src = src[:first] + '#include "prims.h"\n' + src[first:]
    src = re.sub(r"extern __shared__ __align__\(16\) uint8_t raw\[\];",
                 "uint8_t* raw = emu::smem.data();", src)
    return _launches(src)


def build(name: str) -> Path:
    """Compile the emulation of ``csrc/<name>.cu`` (cached by content)."""
    src = source(name)
    extra = "".join((HERE / f).read_text() for f in ("emu.h", "prims.h"))
    tag = hashlib.sha256((src + extra).encode()).hexdigest()[:12]
    lib = OUT / f"lib{name}-emu-{tag}.so"
    if not lib.exists():
        OUT.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cpp = tmp.with_suffix(".cpp")
        cpp.write_text(src)
        subprocess.run(["g++", "-std=c++17", "-O2", "-fPIC", "-shared",
                        "-w", f"-I{HERE}", "-o", str(tmp), str(cpp)],
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=["ssd_scan_bwd"])
    ap.add_argument("--shape", default="2,150,4,64,128",
                    help="Bb,L,H,P,N")
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--dh", action="store_true",
                    help="give the final state a gradient")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    check_ssd_scan_bwd(tuple(int(v) for v in a.shape.split(",")), a.dtype,
                       a.dh, a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
