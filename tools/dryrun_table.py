"""The port's dry-run table: every (arch x shape) pair on one card and
per device of both production meshes, each arch in its own process.

    python3 tools/dryrun_table.py --out build/dryrun_table --jobs 8

runs ``python -m repro_torch.launch.dryrun --force --out-dir OUT``
(``--production-mesh``, ``--multi-pod``) once per arch and mesh, at most
``--jobs`` at a time, then prints, per pair, the bytes a device holds
(parameters, ``resident``), the traced step's collective bytes and
``temp`` in GB, the status and the seconds each pair took, and the wall
time of the whole table.  Without ``--device`` the dry run reads the
card's memory for ``fits`` (one CUDA card); ``--device meta`` does not.
The traces run on fake CPU tensors either way."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"card": [], "pod1": ["--production-mesh"], "pod2": ["--multi-pod"]}


def run(arch: str, mesh: str, out: Path, device) -> tuple:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--force",
           "--arch", arch, "--out-dir", str(out), *MESHES[mesh]]
    if device:
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                   OMP_NUM_THREADS="1"))
    return arch, mesh, proc.returncode, time.perf_counter() - t0, \
        proc.stdout[-3000:] + proc.stderr[-3000:]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.launch.shapes import SHAPES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/dryrun_table")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--device", default=None, help="meta: no fits")
    ap.add_argument("--meshes", default="card,pod1,pod2")
    a = ap.parse_args(argv)
    out = (ROOT / a.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    jobs = [(arch, m) for m in a.meshes.split(",") for arch in ARCH_NAMES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(a.jobs) as ex:
        done = list(ex.map(lambda j: run(*j, out, a.device), jobs))
    wall = time.perf_counter() - t0
    bad = 0
    for arch, mesh, rc, sec, text in done:
        if rc != 0:
            bad += 1
            print(f"[{mesh}] {arch}: exit {rc} after {sec:.1f} s\n{text}")
    where = "meta" if a.device == "meta" else "card"
    print("| config | shape | mesh | status | params GB | resident GB | "
          "collective GB | temp GB | fits | s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for mesh in a.meshes.split(","):
        tag = where if mesh == "card" else f"{mesh}__{where}"
        for arch in ARCH_NAMES:
            for shape in SHAPES:
                f = out / f"{arch}__{shape}__{tag}.json"
                if not f.exists():
                    print(f"| {arch} | {shape} | {mesh} | missing |")
                    continue
                r = json.loads(f.read_text())
                if r["status"] != "ok":
                    print(f"| {arch} | {shape} | {mesh} | {r['status']}: "
                          f"{r.get('error', r.get('reason', ''))[:80]} |")
                    continue
                b = r["bytes"]
                print(f"| {arch} | {shape} | {mesh} | ok | "
                      f"{b['params'] / 1e9:.3f} | {b['resident'] / 1e9:.3f} | "
                      f"{sum(r['collective_bytes'].values()) / 1e9:.3f} | "
                      f"{r['temp'] / 1e9:.3f} | {r['fits']} | "
                      f"{r.get('seconds')} |")
    print(f"[dryrun_table] {len(jobs)} processes, {a.jobs} at a time: "
          f"{wall:.1f} s wall; {bad} failed")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
