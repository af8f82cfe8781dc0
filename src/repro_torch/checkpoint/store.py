"""Pytree checkpointing (npz, no external deps).

Port of the JAX package's ``checkpoint/store.py`` with the same file
layout, so a file written by either package loads in the other:
flattens any nested dict/list tree of arrays into ``path -> array``
entries (``SEP="/"`` paths, ``#i`` keys for list items, a ``__meta__``
JSON entry), saves with np.savez_compressed, restores the structure
from the paths.  Tensors are copied to host numpy before the save
(``to_host``).  Atomic writes (tmp + rename) so an interrupted save
never corrupts the latest checkpoint.  Step-numbered with a retention
policy.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "/"


def to_host(tree: Any) -> Any:
    """The tree with every tensor turned into a host numpy array
    (``detach().cpu().numpy()``); other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{SEP}#{i}" if prefix else f"#{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict = {}
    for path, arr in flat.items():
        keys = path.split(SEP)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr

    def finish(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"#\d+", k) for k in node):
            return [finish(node[f"#{i}"]) for i in range(len(node))]
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


def save(path: str, tree: Any, metadata: Optional[Dict] = None, *,
         compress: bool = True) -> None:
    """Atomic save of a tree (+ json metadata) to ``path`` (.npz).
    ``compress=False`` writes the arrays as they are (``np.load`` reads
    both forms): model weights hardly compress, and zlib over gigabytes
    takes minutes."""
    flat = _flatten(to_host(tree))
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=p.parent, suffix=".tmp")
    os.close(fd)
    write = np.savez_compressed if compress else np.savez
    try:
        write(tmp, __meta__=json.dumps(metadata or {}), **flat)
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz"
                   if os.path.exists(tmp + ".npz") else tmp, p)
    finally:
        for t in (tmp, tmp + ".npz"):
            if os.path.exists(t):
                os.remove(t)


def load(path: str) -> Tuple[Any, Dict]:
    """Returns (tree, metadata)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return _unflatten(flat), meta


class CheckpointManager:
    """Step-numbered checkpoints with retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"ckpt_{step:08d}.npz"

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in self.dir.glob("ckpt_*.npz")
                      if (m := re.match(r"ckpt_(\d+)\.npz", f.name)))

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None):
        save(str(self._path(step)), tree, {**(metadata or {}), "step": step})
        for old in self.steps()[: -self.keep]:
            self._path(old).unlink(missing_ok=True)

    def restore_latest(self) -> Optional[Tuple[int, Any, Dict]]:
        steps = self.steps()
        if not steps:
            return None
        tree, meta = load(str(self._path(steps[-1])))
        return steps[-1], tree, meta
