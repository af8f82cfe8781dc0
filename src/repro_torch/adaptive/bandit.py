"""Contextual-bandit model-quality learner (PickLLM / RouteLLM-style
online routing, layered onto the paper's static MRES scores).

One linear-bandit posterior per catalog model, kept as PACKED arrays so
a whole batch learns in one fused pass:

  A      (N, D, D)  regularized scatter matrices  (lam * I prior)
  b      (N, D)     reward-weighted context sums
  theta  (N, D)     ridge estimates A^{-1} b      (cached)
  Ainv   (N, D, D)  precision inverses            (cached)

The context of a query is its (M,) routing task vector (user preference
weights with the accuracy axis raised to the analyzed complexity) plus
an intercept, so D = M + 1: the intercept learns each model's base
quality and the weight axes learn how quality co-varies with what the
user asked for.

Policies over the shared posterior:

  * ``linucb``   — score = x.theta + alpha * sqrt(x^T Ainv x)
  * ``thompson`` — score = x.theta~ with theta~ ~ N(theta, noise^2 Ainv)

Thompson draws ``z`` from the bandit's own ``np.random.default_rng(seed)``
on the host, exactly as the reference does: the generator stays
explicit, and the port and the reference draw the same stream, which
is what lets the two be compared.  Only the staged routing path serves
it (``RoutingEngine.route_many_staged``), scoring at most B*k candidate
columns, so the Cholesky of their 9x9 ``Ainv`` and the score matmuls
stay host numpy, as in the reference.

Non-stationarity is handled by exponential forgetting (``forget`` < 1
decays A toward the lam*I prior and b toward 0 on every outcome batch),
so the posterior tracks drifting model quality instead of averaging
over it.

The posterior stays host-side numpy.  The learning step runs on
``device`` under both policies: ``update`` builds the (B, N) choice
mask there and the hand-written ``bandit_update`` kernel forms the
rank-1 deltas (dA, db) of the whole batch (the reference's numpy path
for Thompson forms the same deltas); ``update_and_score`` also takes
the next batch's LinUCB scores from the same launch.  ``device="cpu"``
runs the kernel's plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.preferences import N_METRICS
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

POLICIES = ("linucb", "thompson")


class LinearBandit:
    def __init__(self, n_models: int, context_dim: int = N_METRICS, *,
                 policy: str = "linucb", alpha: float = 0.8,
                 lam: float = 1.0, noise: float = 0.3,
                 forget: float = 1.0, seed: int = 0, device=None):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        assert 0.0 < forget <= 1.0, forget
        self.policy = policy
        self.alpha = float(alpha)
        self.lam = float(lam)
        self.noise = float(noise)
        self.forget = float(forget)
        self._rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.dim = context_dim + 1                     # + intercept
        self.n_models = 0
        self.A = np.zeros((0, self.dim, self.dim), np.float32)
        self.b = np.zeros((0, self.dim), np.float32)
        self.counts = np.zeros(0, np.int64)
        self._theta: Optional[np.ndarray] = None
        self._ainv: Optional[np.ndarray] = None
        self.ensure(n_models)

    # ---------------- capacity ----------------
    def ensure(self, n_models: int) -> None:
        """Grow to ``n_models`` arms (fresh lam*I priors for new ones) —
        keeps the bandit consistent when the catalog grows (merging)."""
        if n_models <= self.n_models:
            return
        grow = n_models - self.n_models
        eye = np.broadcast_to(self.lam * np.eye(self.dim, dtype=np.float32),
                              (grow, self.dim, self.dim))
        self.A = np.concatenate([self.A, eye.copy()], axis=0)
        self.b = np.concatenate(
            [self.b, np.zeros((grow, self.dim), np.float32)], axis=0)
        self.counts = np.concatenate(
            [self.counts, np.zeros(grow, np.int64)])
        self.n_models = n_models
        self._theta = self._ainv = None

    # ---------------- posterior ----------------
    def _ctx(self, X: np.ndarray) -> np.ndarray:
        """(B, M) task vectors -> (B, D) contexts with intercept."""
        X = np.asarray(X, np.float32)
        assert X.ndim == 2 and X.shape[1] == self.dim - 1, \
            (X.shape, self.dim)
        return np.concatenate(
            [X, np.ones((X.shape[0], 1), np.float32)], axis=1)

    def _refresh(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._theta is None or self._ainv is None:
            self._ainv = np.linalg.inv(self.A).astype(np.float32)
            self._theta = np.einsum("nde,ne->nd", self._ainv,
                                    self.b).astype(np.float32)
        return self._theta, self._ainv

    @property
    def theta(self) -> np.ndarray:
        """(N, D) current per-model reward estimates."""
        return self._refresh()[0]

    def posterior(self) -> Tuple[np.ndarray, np.ndarray]:
        """(theta (N, D), Ainv (N, D, D)) under the current posterior —
        the arrays the fused ``route_step`` program scores LinUCB
        against on device."""
        return self._refresh()

    def predict(self, X: np.ndarray) -> np.ndarray:
        """(B, N) posterior-mean reward estimates (no exploration)."""
        theta, _ = self._refresh()
        return self._ctx(X) @ theta.T

    def scores(self, X: np.ndarray) -> np.ndarray:
        """(B, N) policy scores for (B, M) task-vector contexts."""
        return self.scores_at(X, None)

    def scores_at(self, X: np.ndarray, cols: Optional[np.ndarray]
                  ) -> np.ndarray:
        """(B, C) policy scores restricted to the ``cols`` model subset
        (None = all models): the staged routing path scores only its
        kNN candidate columns.  Thompson draws one posterior sample per
        column, ``z`` (C, D) from the bandit's generator."""
        theta, ainv = self._refresh()
        ctx = self._ctx(X)
        if cols is not None:
            theta, ainv = theta[cols], ainv[cols]
        if self.policy == "thompson":
            # theta~ = theta + noise * L z,  L L^T = Ainv
            L = np.linalg.cholesky(
                ainv + 1e-6 * np.eye(self.dim, dtype=np.float32))
            z = self._rng.standard_normal(
                (theta.shape[0], self.dim)).astype(np.float32)
            theta = theta + self.noise * np.einsum("nde,ne->nd", L, z)
            return ctx @ theta.T
        mean = ctx @ theta.T                                    # (B, C)
        # x^T Ainv x over the flattened rank-1 layout: one matmul
        xx = (ctx[:, :, None] * ctx[:, None, :]).reshape(ctx.shape[0], -1)
        var = xx @ ainv.reshape(theta.shape[0], -1).T
        return mean + self.alpha * np.sqrt(np.maximum(var, 0.0))

    # ---------------- learning ----------------
    def _choice_mask(self, chosen: np.ndarray, B: int) -> torch.Tensor:
        """(B, N) one-hot choice mask, built on the device."""
        chosen = np.asarray(chosen)
        assert chosen.shape == (B,), (chosen.shape, B)
        assert (chosen >= 0).all() and (chosen < self.n_models).all(), chosen
        w = torch.zeros((B, self.n_models), dtype=torch.float32,
                        device=self.device)
        w[torch.arange(B, device=self.device),
          torch.as_tensor(chosen, dtype=torch.int64, device=self.device)] = 1.0
        return w

    def _apply(self, dA: np.ndarray, db: np.ndarray,
               chosen: np.ndarray) -> None:
        if self.forget < 1.0:
            eye = self.lam * np.eye(self.dim, dtype=np.float32)
            self.A = self.forget * (self.A - eye) + eye
            self.b = self.forget * self.b
        self.A += dA
        self.b += db
        self.counts += np.bincount(np.asarray(chosen, np.int64),
                                   minlength=self.n_models)
        self._theta = self._ainv = None

    def update(self, X: np.ndarray, chosen: np.ndarray,
               rewards: np.ndarray) -> None:
        """Fold one outcome batch into the posterior.

        X (B, M) task vectors; chosen (B,) catalog indices served;
        rewards (B,) shaped rewards observed.  The deltas come from the
        ``bandit_update`` kernel with no scoring rows, so the posterior
        is neither read nor refreshed.
        """
        ctx = self._ctx(X)
        B = ctx.shape[0]
        if B == 0:
            return
        r = np.asarray(rewards, np.float32)
        w = self._choice_mask(chosen, B)
        dA, db, _ = ops.bandit_update(ctx, w, r, ctx[:0], None, None, 0.0,
                                      device=self.device)
        self._apply(dA.cpu().numpy(), db.cpu().numpy(), chosen)

    # ---------------- persistence ----------------
    def state(self) -> dict:
        """Sufficient statistics snapshot: (A, b, counts) determine the
        whole posterior (theta/Ainv are derived caches)."""
        return {"A": self.A.copy(), "b": self.b.copy(),
                "counts": self.counts.copy()}

    def load_state(self, state: dict) -> None:
        """Restore a ``state()`` snapshot, REPLACING the posterior."""
        A = np.asarray(state["A"], np.float32)
        if A.ndim != 3 or A.shape[1:] != (self.dim, self.dim):
            raise ValueError(f"bandit dim mismatch: snapshot {A.shape}, "
                             f"expected (*, {self.dim}, {self.dim})")
        self.A = A.copy()
        self.b = np.asarray(state["b"], np.float32).copy()
        self.counts = np.asarray(state["counts"], np.int64).copy()
        self.n_models = int(A.shape[0])
        self._theta = self._ainv = None

    def update_and_score(self, X_up: np.ndarray, chosen: np.ndarray,
                         rewards: np.ndarray, X_score: np.ndarray
                         ) -> np.ndarray:
        """Serving-cadence step: score the incoming batch under the
        CURRENT posterior, then fold the finished batch's outcomes in.
        Both halves are one ``bandit_update`` launch.  Returns the
        (Bs, N) LinUCB scores; a Thompson bandit samples its scores
        (``scores``) and then updates, as the reference does.
        """
        if self.policy == "thompson":
            s = self.scores(X_score)
            self.update(X_up, chosen, rewards)
            return s
        ctx_up = self._ctx(X_up)
        B = ctx_up.shape[0]
        w = self._choice_mask(chosen, B) if B else \
            torch.zeros((0, self.n_models), dtype=torch.float32,
                        device=self.device)
        r = np.asarray(rewards, np.float32)
        theta, ainv = self._refresh()
        dA, db, ucb = ops.bandit_update(
            ctx_up, w, r, self._ctx(X_score), theta, ainv, self.alpha,
            device=self.device)
        if B:                # empty batch: no update, no forgetting
            self._apply(dA.cpu().numpy(), db.cpu().numpy(), chosen)
        return ucb.cpu().numpy()
