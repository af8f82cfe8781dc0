"""Durable router state: everything the router LEARNS survives restart.

Port of the JAX package's ``checkpoint/router_state.py``, with the same
tree and metadata, so a snapshot saved by either package restores in
the other.  A serving deployment accumulates routing knowledge that is
expensive to re-learn from live traffic: the adaptive bandit's
sufficient statistics (``repro_torch.adaptive.LinearBandit``), the
thumbs-feedback biases (``FeedbackStore``), the load tracker's
service-time EWMAs and capacities (``LoadTracker``), and the semantic
cache's validated responses (``repro_torch.cache.semantic``).  All of it evaporates on
process death unless snapshotted — a restarted engine then routes cold
for thousands of requests.

``RouterState`` captures every attached component of an ``OptiRoute``
into one tree + JSON-metadata pair and persists it through the npz
checkpoint store: atomic (tmp + rename — a crash mid-save
never corrupts the latest snapshot), step-versioned with retention
(``CheckpointManager``), and bit-exact (restore reproduces identical
``route_many`` decisions).  Components the router does not carry are
simply skipped; restoring a snapshot into a router that LACKS a
component the snapshot carries raises (a silent partial restore would
masquerade as warm).

    state = RouterState(directory)
    state.save(router, step=120)          # cadence chosen by the caller
    ...
    router2 = build_router(...)           # fresh process
    state.restore(router2)                # resumes warm

``save_router_state`` / ``load_router_state`` are the single-file
variants for callers managing their own paths.
"""
from __future__ import annotations

import pathlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.store import (CheckpointManager, load, save,
                                         to_host)

STATE_VERSION = 1


# ----------------------------------------------------------------------
# capture / apply
# ----------------------------------------------------------------------

def _cache_tree(cache) -> Tuple[Dict, Dict]:
    st = cache.state()
    resp: Dict[str, np.ndarray] = {}
    for i, r in enumerate(st["responses"]):
        if r is None:
            continue
        # a tensor response is copied to host numpy, never pickled
        a = np.asarray(to_host(r))
        if a.dtype == object:
            raise TypeError("RouterState persists array (or None) cache "
                            f"responses; slot {i} holds {type(r)}")
        resp[str(i)] = a
    tree = {"vecs": st["vecs"], "fps": st["fps"],
            "quality": st["quality"], "created": st["created"],
            "last_used": st["last_used"], "valid": st["valid"],
            "responses": resp}
    meta = {"tick": int(st["tick"]), "models": st["models"],
            "sigs": st["sigs"]}
    return tree, meta


def _cache_state(tree: Dict, meta: Dict) -> Dict:
    C = int(np.asarray(tree["valid"]).shape[0])
    responses: list = [None] * C
    for k, a in (tree.get("responses") or {}).items():
        responses[int(k)] = np.asarray(a)
    return {"vecs": tree["vecs"], "fps": tree["fps"],
            "quality": tree["quality"], "created": tree["created"],
            "last_used": tree["last_used"],
            "valid": np.asarray(tree["valid"], bool),
            "tick": int(meta["tick"]), "models": list(meta["models"]),
            "responses": responses,
            "sigs": [None if s is None else tuple(s)
                     for s in meta["sigs"]]}


def capture(router) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One consistent (tree, metadata) snapshot of every learned
    component the ``OptiRoute`` carries."""
    tree: Dict[str, Any] = {}
    meta: Dict[str, Any] = {"router_state_version": STATE_VERSION,
                            "components": []}
    bandit = getattr(router, "adaptive", None)
    if bandit is not None:
        tree["bandit"] = bandit.state()
        meta["components"].append("bandit")
    fb = getattr(router, "feedback", None)
    if fb is not None:
        entries = fb.state()
        tree["feedback"] = {
            # float64: the store keeps python floats, and the restore
            # must reproduce them (and the routing scores) bit-exactly
            "bias": np.array([e["bias"] for e in entries], np.float64),
            "count": np.array([e["count"] for e in entries], np.int64),
        }
        meta["feedback_keys"] = [[*e["cluster"], e["model"]]
                                 for e in entries]
        meta["components"].append("feedback")
    tracker = getattr(router, "load", None)
    if tracker is not None:
        tree["load"] = tracker.state()
        meta["components"].append("load")
    cache = getattr(router, "cache", None)
    if cache is not None:
        tree["cache"], meta["cache"] = _cache_tree(cache)
        meta["components"].append("cache")
    return tree, meta


def apply(router, tree: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Restore a ``capture`` snapshot into ``router``, replacing the
    live state of every captured component."""
    version = meta.get("router_state_version")
    if version != STATE_VERSION:
        raise ValueError(f"router state version {version!r} != "
                         f"{STATE_VERSION}")
    for comp in meta["components"]:
        target = getattr(router, comp if comp != "bandit" else "adaptive",
                         None)
        if target is None:
            raise ValueError(f"snapshot carries {comp!r} but the router "
                             "has no such component attached")
    if "bandit" in meta["components"]:
        router.adaptive.load_state(tree["bandit"])
    if "feedback" in meta["components"]:
        fbt = tree["feedback"]
        bias = np.atleast_1d(np.asarray(fbt["bias"]))
        count = np.atleast_1d(np.asarray(fbt["count"]))
        router.feedback.load_state([
            {"cluster": [k[0], k[1], int(k[2])], "model": k[3],
             "bias": float(b), "count": int(c)}
            for k, b, c in zip(meta["feedback_keys"], bias, count)])
    if "load" in meta["components"]:
        router.load.load_state(tree["load"])
    if "cache" in meta["components"]:
        router.cache.load_state(_cache_state(tree["cache"], meta["cache"]))


# ----------------------------------------------------------------------
# single-file + step-versioned persistence
# ----------------------------------------------------------------------

def save_router_state(path: str, router) -> None:
    """Atomic single-file snapshot (npz, tmp + rename)."""
    tree, meta = capture(router)
    save(path, tree, meta)


def load_router_state(path: str, router) -> Dict[str, Any]:
    """Restore a ``save_router_state`` snapshot; returns its metadata."""
    tree, meta = load(path)
    apply(router, _none_empty(tree), meta)
    return meta


def _none_empty(tree) -> Dict[str, Any]:
    # an all-empty component (e.g. feedback with zero entries) can
    # flatten to nothing; normalize to dicts the apply path expects
    return tree if isinstance(tree, dict) else {}


class RouterState:
    """Step-versioned durable router state with retention, built on the
    atomic ``CheckpointManager``."""

    def __init__(self, directory: str, keep: int = 3):
        self.mgr = CheckpointManager(directory, keep=keep)

    def save(self, router, step: int) -> pathlib.Path:
        tree, meta = capture(router)
        self.mgr.save(step, tree, meta)
        return self.mgr._path(step)

    def restore(self, router) -> Optional[int]:
        """Restore the latest snapshot; returns its step, or None when
        the directory holds no snapshots (a cold start)."""
        latest = self.mgr.restore_latest()
        if latest is None:
            return None
        step, tree, meta = latest
        apply(router, _none_empty(tree), meta)
        return step
