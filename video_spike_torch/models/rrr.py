"""Reduced-rank regression (RRR) spike predictor.

Counterpart of ``video_spike_tpu/models/rrr.py`` (reference
``src/model/rrr.py:29-202``):

- per-session factors ``U: (N, ncoef-1, ncomp)`` and bias ``b: (N, 1, T)``
  (initialized to the train-mean PSTH), with ``V: (ncomp, T)`` shared across
  sessions; ``beta = concat(U @ V, b)`` -> (N, ncoef, T);
- prediction ``einsum("ktc,nct->ktn", X, beta)``;
- objective: summed squared error on the train split plus ``l2 * sum(beta²)``;
- ``predict_y_fr`` un-standardizes with stored per-session mean/std.

The init draws from ``np.random.seed(0)`` exactly as the JAX package and the
reference do, so factor scales and values match.

Solvers (``fit(solver=...)``):

- ``"als"``, the production solver: the closed-form two-block alternating
  least squares of the JAX package. With V's rows orthonormalized (QR) the
  joint (U, b) problem is one ridge solve shared across neurons; with (U, b)
  fixed each time slice of V is a small generalized-ridge solve with penalty
  matrix UᵀU. ``jax.lax.scan`` over ``min(max_iter, 30)`` iterations is a
  Python loop here. The QR basis may differ in sign between libraries, which
  flips U and V together: β = U·V and b do not depend on it.
- ``"lbfgs"``, the reference-parity optimizer: ``torch.optim.LBFGS`` with
  the strong-Wolfe line search (the JAX package runs ``optax.lbfgs`` with a
  zoom line search, so the iterates differ; the objective they reach is
  what is compared).

Tensors live on the ``device`` given to the model; the fit runs in float32,
with TF32 off on the card (the normal equations are ill-conditioned).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from video_spike_torch.core.device import resolve_device


def _init_params(train_data: Dict, ncomp: int) -> Dict[str, np.ndarray]:
    np.random.seed(0)
    params: Dict[str, np.ndarray] = {}
    V = None
    for eid in train_data:
        X = train_data[eid]["X"][0]
        y = train_data[eid]["y"][0]
        K, T, ncoef = X.shape
        N = y.shape[2]
        U = np.random.normal(size=(N, ncoef - 1, ncomp)) / np.sqrt(T * ncomp)
        V = np.random.normal(size=(ncomp, T)) / np.sqrt(T * ncomp)
        b = np.ascontiguousarray(np.expand_dims(y.mean(0).T, 1))
        params[f"{eid}_U"] = U.astype(np.float32)
        params[f"{eid}_b"] = b.astype(np.float32)
    params["V"] = V.astype(np.float32)  # shared; last session's draw (parity)
    return params


def compute_beta(params: Dict, eid: str, withbias: bool = True) -> torch.Tensor:
    """(N, ncoef, T) coefficient tensor for one session."""
    beta = torch.einsum("ncr,rt->nct", params[f"{eid}_U"], params["V"])
    b = params[f"{eid}_b"]
    if not withbias:
        b = torch.zeros_like(b)
    return torch.cat([beta, b], dim=1)


def predict(beta: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """X: (K, T, ncoef), beta: (N, ncoef, T) -> (K, T, N)."""
    return torch.einsum("ktc,nct->ktn", X, beta)


def _als_precompute(X: torch.Tensor, y: torch.Tensor):
    """Session sufficient statistics — everything the ALS blocks need.

    X: (K, T, ncoef) whose trailing column multiplies the per-(neuron, time)
    coefficient b, y: (K, T, N)."""
    Xm, xb = X[:, :, :-1], X[:, :, -1]
    S = torch.einsum("kta,ktb->tab", Xm, Xm)    # (T, C, C)
    sxb = torch.einsum("ktc,kt->tc", Xm, xb)    # (T, C)
    s2 = (xb * xb).sum(dim=0)                   # (T,)
    P = torch.einsum("ktc,ktn->tcn", Xm, y)     # (T, C, N)
    syb = torch.einsum("kt,ktn->tn", xb, y)     # (T, N)
    return S, sxb, s2, P, syb


def _als_fit(pre, Us, V, bs, l2: float, n_iter: int):
    """Two-block exact ALS on the RRR objective (see module docstring).

    pre: list of per-session stats from :func:`_als_precompute`;
    Us: list of (N, C, R); V: (R, T); bs: list of (N, T). Returns the
    minimizing (Us, V, bs)."""
    T, R = V.shape[1], V.shape[0]
    dev = V.device
    eps = 1e-6  # numerical jitter for the l2=0 case; data is standardized
    eye_r = torch.eye(R, device=dev)
    for _ in range(n_iter):
        # joint (U, b) ridge per session, V rows orthonormalized so the l2
        # penalty on beta = U_flat V becomes plain l2 ||U_flat||²
        Q, _ = torch.linalg.qr(V.T)            # (T, R), orthonormal columns
        Vt = Q.T                               # spans the same rows as V
        new_Us, new_bs = [], []
        for (S, sxb, s2, P, syb), U in zip(pre, Us):
            N, C, _ = U.shape
            d = C * R
            FtF = torch.einsum("tab,rt,st->arbs", S, Vt, Vt).reshape(d, d)
            FtE = torch.einsum("tc,rt->crt", sxb, Vt).reshape(d, T)
            FtY = torch.einsum("tcn,rt->crn", P, Vt).reshape(d, N)
            A = torch.cat([torch.cat([FtF, FtE], dim=1),
                           torch.cat([FtE.T, torch.diag(s2)], dim=1)], dim=0)
            A = A + (l2 + eps) * torch.eye(d + T, device=dev)
            W = torch.linalg.solve(A, torch.cat([FtY, syb], dim=0))
            new_Us.append(W[:d].T.reshape(N, C, R))
            new_bs.append(W[d:].T)             # (N, T)
        # shared-V generalized ridge, one small solve per time slice,
        # sufficient statistics summed across sessions
        GtG = torch.zeros((T, R, R), device=dev)
        rhs = torch.zeros((T, R), device=dev)
        M = torch.zeros((R, R), device=dev)
        for (S, sxb, s2, P, syb), U, b in zip(pre, new_Us, new_bs):
            Q4 = torch.einsum("ncr,nds->cdrs", U, U)
            GtG = GtG + torch.einsum("tcd,cdrs->trs", S, Q4)
            M = M + torch.einsum("ncr,ncs->rs", U, U)
            rhs = rhs + (torch.einsum("ncr,tcn->tr", U, P)
                         - torch.einsum("ncr,tc,nt->tr", U, sxb, b))
        A = GtG + l2 * M[None] + eps * eye_r[None]
        V = torch.linalg.solve(A, rhs[..., None])[..., 0].T  # (R, T)
        Us, bs = new_Us, new_bs
    return Us, V, bs


class RRRGD:
    """Multi-session reduced-rank regressor with shared temporal basis V."""

    def __init__(self, train_data: Dict, ncomp: int, l2: float = 0.0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.l2 = float(l2)
        self.eids = list(train_data.keys())
        self.withbias = True
        self.n_comp = ncomp
        self.params = {k: torch.from_numpy(v).to(self.device)
                       for k, v in _init_params(train_data, ncomp).items()}
        self.T = self.params["V"].shape[1]
        self.N = sum(train_data[e]["y"][0].shape[2] for e in self.eids)

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=torch.float32,
                               device=self.device)

    def _train_split(self, train_data: Dict) -> Dict:
        return {eid: {"X": self._tensor(train_data[eid]["X"][0]),
                      "y": self._tensor(train_data[eid]["y"][0])}
                for eid in self.eids}

    # ------------------------------------------------------------------
    def loss_fn(self, params: Dict, data: Dict) -> torch.Tensor:
        """Total train MSE + l2 regularization over all sessions."""
        total = torch.zeros((), device=self.device)
        for eid in self.eids:
            beta = compute_beta(params, eid, self.withbias)
            ypred = predict(beta, data[eid]["X"])
            total = total + ((ypred - data[eid]["y"]) ** 2).sum()
            total = total + self.l2 * (beta ** 2).sum()
        return total

    def fit(self, train_data: Dict, max_iter: int = 120,
            tol: float = 1e-7, solver: str = "lbfgs") -> float:
        """Fit on the train split (k=0 arrays). Returns the final loss.

        solver="als" dispatches to the closed-form block solver
        (:meth:`fit_als`); "lbfgs" keeps the reference-parity optimizer."""
        if solver == "als":
            return self.fit_als(train_data, n_iter=min(max_iter, 30))
        if solver != "lbfgs":
            raise ValueError(f"unknown RRR solver {solver!r} (als or lbfgs)")
        data = self._train_split(train_data)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in self.params.items()}
        opt = torch.optim.LBFGS(list(leaves.values()), lr=1.0,
                                max_iter=max_iter, tolerance_grad=tol,
                                history_size=10,
                                line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad()
            loss = self.loss_fn(leaves, data)
            loss.backward()
            return loss

        opt.step(closure)
        self.params = {k: v.detach() for k, v in leaves.items()}
        with torch.no_grad():
            return float(self.loss_fn(self.params, data))

    @torch.no_grad()
    def fit_als(self, train_data: Dict, n_iter: int = 30) -> float:
        """Closed-form two-block ALS fit (the production solver)."""
        data = self._train_split(train_data)
        pre = [_als_precompute(data[e]["X"], data[e]["y"]) for e in self.eids]
        Us = [self.params[f"{e}_U"] for e in self.eids]
        bs = [self.params[f"{e}_b"][:, 0, :] for e in self.eids]
        Us, V, bs = _als_fit(pre, Us, self.params["V"], bs, self.l2, n_iter)
        self.params["V"] = V
        for eid, U, b in zip(self.eids, Us, bs):
            self.params[f"{eid}_U"] = U
            self.params[f"{eid}_b"] = b[:, None, :]
        return float(self.loss_fn(self.params, data))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict_y(self, data: Dict, eid: str, k: int):
        beta = compute_beta(self.params, eid, self.withbias)
        X = self._tensor(data[eid]["X"][k])
        y = self._tensor(data[eid]["y"][k])
        return X, y, predict(beta, X)

    def predict_y_fr(self, data: Dict, eid: str, k: int):
        """Prediction un-standardized back to firing-rate space."""
        X, y, ypred = self.predict_y(data, eid, k)
        mean_y = self._tensor(data[eid]["setup"]["mean_y_TN"])
        std_y = self._tensor(data[eid]["setup"]["std_y_TN"])
        return X, y * std_y + mean_y, ypred * std_y + mean_y

    def compute_MSE(self, data: Dict, k: int) -> Dict[str, np.ndarray]:
        """Per-session per-neuron summed squared error on split k."""
        out = {}
        for eid in self.eids:
            _, y, ypred = self.predict_y(data, eid, k)
            out[eid] = ((ypred - y) ** 2).sum(dim=(0, 1)).cpu().numpy()
        return out

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """The JAX package's pickle layout: numpy float32 arrays."""
        return {
            "model": {k: v.detach().cpu().numpy()
                      for k, v in self.params.items()},
            "l2": self.l2,
            "eids": self.eids,
            "N": self.N,
            "T": self.T,
            "n_comp": self.n_comp,
        }

    def load_state_dict(self, state: dict) -> None:
        self.params = {k: self._tensor(v) for k, v in state["model"].items()}

    def save(self, path: str | Path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.state_dict(), f)

    @classmethod
    def load(cls, path: str | Path, train_data: Dict,
             device="cuda") -> "RRRGD":
        """Read a pickle written by :meth:`save` (this package's or the JAX
        package's; only trusted files: unpickling runs code)."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        model = cls(train_data, state["n_comp"], l2=state["l2"], device=device)
        model.load_state_dict(state)
        return model


def train_model_main(train_data: Dict, l2: float, n_comp: int,
                     model_fname: str = "tmp", save: bool = True,
                     max_iter: int = 120, solver: str = "als",
                     device="cuda") -> Tuple[RRRGD, dict]:
    """Fit an RRR model (reference ``src/model/rrr.py:192-202``): fit,
    validation MSE report, optional save. The default solver is the
    closed-form ALS; pass solver="lbfgs" for the reference-parity
    optimizer."""
    model = RRRGD(train_data, n_comp, l2=l2, device=device)
    model.fit(train_data, max_iter=max_iter, solver=solver)
    mses_val = model.compute_MSE(train_data, 1)
    best_loss = float(np.sum(np.concatenate(list(mses_val.values()))))
    if save:
        model.save(model_fname if str(model_fname).endswith(".pkl")
                   else f"{model_fname}.pkl")
    return model, {"mses_val": mses_val, "mse_val_mean": best_loss}
