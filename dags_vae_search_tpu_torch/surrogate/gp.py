"""GP regression surrogate: latent vector z -> structure score (torch).

Counterpart of ``dags_vae_search_tpu/surrogate/gp.py``.  Two models, both
differentiable in their inputs (the posterior drives gradient-ascent latent
search):

- :class:`ExactGP` — full Cholesky exact GP;
- :class:`SGPR` — Titsias variational inducing-point regression, the
  inducing points optimized jointly with the hyperparameters.

Targets are standardized internally (predictions come back in the original
scale); the kernel is a scalar-lengthscale RBF with an outputscale and
Gaussian noise, all softplus-parameterized.  The fit is ``iters`` Adam
steps (optax's update: betas 0.9/0.999, eps 1e-8, bias-corrected) on the
negative marginal log-likelihood, on the model's device.

A Cholesky factorisation that fails gives NaN, as ``jnp.linalg.cholesky``
does (``torch.linalg.cholesky`` would raise and read back to the host each
step); a failed fit therefore shows as a non-finite ``final_nmll``.
Products run in full float32 (never TF32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dags_vae_search_tpu_torch.ops.bic_torch import exact_f32_matmul


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) as jax.nn.softplus computes it (torch's softplus turns
    # linear above x = 20)
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(y)))


class GPParams(NamedTuple):
    mean_const: torch.Tensor
    raw_outputscale: torch.Tensor
    raw_lengthscale: torch.Tensor
    raw_noise: torch.Tensor


def init_params(device="cuda") -> GPParams:
    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return GPParams(
        mean_const=scalar(0.0),
        raw_outputscale=scalar(_inv_softplus(1.0)),
        raw_lengthscale=scalar(_inv_softplus(1.0)),
        raw_noise=scalar(_inv_softplus(0.1)),
    )


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a_i - b_j|^2 as a^2 - 2ab + b^2, clamped at 0 (the JAX package's
    expansion, not ``torch.cdist``)."""
    a2 = (a * a).sum(dim=-1, keepdim=True)
    b2 = (b * b).sum(dim=-1, keepdim=True)
    return torch.clamp(a2 - 2.0 * (a @ b.T) + b2.T, min=0.0)


def rbf_kernel(params: GPParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lengthscale = _softplus(params.raw_lengthscale)
    outputscale = _softplus(params.raw_outputscale)
    return outputscale * torch.exp(-0.5 * _sq_dists(a, b) / (lengthscale**2))


def _cholesky(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the factorisation fails."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where(info == 0, chol, torch.nan)


def _solve_lower(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(chol, b, upper=False)


def _adam(tensors, learning_rate: float) -> torch.optim.Adam:
    return torch.optim.Adam(tensors, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _leaves(params: GPParams) -> list:
    return [p.detach().clone().requires_grad_(True) for p in params]


class ExactGP:
    """Exact GP regression with standardized targets, on ``device``."""

    def __init__(self, jitter: float = 1e-4, device="cuda"):
        self.jitter = jitter
        self.device = torch.device(device)
        self.params: Optional[GPParams] = None
        self._x = None
        self._y_std = None
        self._y_mean = None
        self._y_scale = None
        self._chol = None
        self._alpha = None

    def _standardize(self, x, y) -> tuple:
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)
        y = np.asarray(y, dtype=np.float64)
        self._y_mean = float(y.mean())
        self._y_scale = float(y.std() + 1e-12)
        y_std = torch.as_tensor((y - self._y_mean) / self._y_scale, dtype=torch.float32,
                                device=self.device)
        return x, y_std

    def _nmll(self, params: GPParams, x, y) -> torch.Tensor:
        n = x.shape[0]
        noise = _softplus(params.raw_noise) + self.jitter
        k = rbf_kernel(params, x, x) + noise * torch.eye(n, device=x.device)
        chol = _cholesky(k)
        resid = y - params.mean_const
        alpha = torch.cholesky_solve(resid[:, None], chol, upper=False)[:, 0]
        logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
        return 0.5 * (resid @ alpha + logdet + n * math.log(2.0 * math.pi))

    def fit(
        self,
        x: np.ndarray,
        y: np.ndarray,
        iters: int = 500,
        learning_rate: float = 0.01,
        init: Optional[GPParams] = None,
    ) -> "ExactGP":
        """``iters`` Adam steps from ``init`` (a previous fit's parameters,
        e.g. the last round of the closed BO loop) or :func:`init_params`."""
        x, y_std = self._standardize(x, y)
        leaves = _leaves(init if init is not None else init_params(self.device))
        opt = _adam(leaves, learning_rate)
        losses = []
        with exact_f32_matmul():
            for _ in range(iters):
                opt.zero_grad(set_to_none=True)
                loss = self._nmll(GPParams(*leaves), x, y_std)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            params = GPParams(*(p.detach() for p in leaves))
            self.final_nmll = float(losses[-1]) if losses else float("nan")
            noise = _softplus(params.raw_noise) + self.jitter
            k = rbf_kernel(params, x, x) + noise * torch.eye(x.shape[0], device=x.device)
            self._chol = _cholesky(k)
            self._alpha = torch.cholesky_solve(
                (y_std - params.mean_const)[:, None], self._chol, upper=False
            )[:, 0]
        self.params = params
        self._x = x
        self._y_std = y_std
        return self

    def posterior_mean_std(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Standardized-space posterior (differentiable in ``xs``)."""
        with exact_f32_matmul():
            ks = rbf_kernel(self.params, xs, self._x)
            mean = self.params.mean_const + ks @ self._alpha
            v = _solve_lower(self._chol, ks.T)
        kss = _softplus(self.params.raw_outputscale)
        var = torch.clamp(kss - (v * v).sum(dim=0), min=1e-12)
        return mean, torch.sqrt(var)

    def _posterior_np(self, xs) -> tuple:
        xs = torch.as_tensor(np.asarray(xs), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            mean, std = self.posterior_mean_std(xs)
        return mean.cpu().numpy(), std.cpu().numpy()

    def predict(self, xs: np.ndarray) -> np.ndarray:
        """Posterior mean in the original target scale."""
        mean, _ = self._posterior_np(xs)
        return mean * self._y_scale + self._y_mean

    def predict_with_std(self, xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean, std = self._posterior_np(xs)
        return mean * self._y_scale + self._y_mean, std * self._y_scale


class SGPR(ExactGP):
    """Titsias sparse GP (inducing points).  Inducing locations start from
    the head of the training set and are optimized jointly."""

    def __init__(self, num_inducing: int = 500, jitter: float = 1e-4, device="cuda"):
        super().__init__(jitter, device)
        self.num_inducing = num_inducing
        self.inducing: Optional[torch.Tensor] = None

    def _terms(self, params: GPParams, z: torch.Tensor, x: torch.Tensor, y_std: torch.Tensor):
        """(noise, lu, lb, a, c) of the collapsed bound at inducing points z."""
        m = z.shape[0]
        eye = torch.eye(m, device=z.device)
        noise = _softplus(params.raw_noise) + self.jitter
        kuu = rbf_kernel(params, z, z) + self.jitter * eye
        kuf = rbf_kernel(params, z, x)
        lu = _cholesky(kuu)
        a = _solve_lower(lu, kuf)  # [m, n]
        lb = _cholesky(eye + (a @ a.T) / noise)
        resid = y_std - params.mean_const
        c = _solve_lower(lb, (a @ resid)[:, None])[:, 0] / noise
        return noise, lu, lb, a, c

    def _bound(self, params: GPParams, z, x, y_std) -> torch.Tensor:
        """Negative Titsias collapsed bound."""
        n = x.shape[0]
        noise, _, lb, a, c = self._terms(params, z, x, y_std)
        resid = y_std - params.mean_const
        logdet = 2.0 * torch.log(torch.diagonal(lb)).sum() + n * torch.log(noise)
        quad = (resid @ resid) / noise - c @ c
        kdiag = _softplus(params.raw_outputscale) * n
        trace = (kdiag - (a * a).sum()) / noise
        return 0.5 * (logdet + quad + n * math.log(2.0 * math.pi) + trace)

    def fit(self, x, y, iters: int = 500, learning_rate: float = 0.01) -> "SGPR":
        x, y_std = self._standardize(x, y)
        m = min(self.num_inducing, x.shape[0])
        leaves = _leaves(init_params(self.device))
        z = x[:m].clone().requires_grad_(True)
        opt = _adam(leaves + [z], learning_rate)
        losses = []
        with exact_f32_matmul():
            for _ in range(iters):
                opt.zero_grad(set_to_none=True)
                loss = self._bound(GPParams(*leaves), z, x, y_std)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            self.params = GPParams(*(p.detach() for p in leaves))
            self.inducing = z.detach()
            self.final_nmll = float(losses[-1]) if losses else float("nan")
            _, self._lu, self._lb, _, self._c = self._terms(self.params, self.inducing, x, y_std)
        self._x = x
        self._y_std = y_std
        return self

    def posterior_mean_std(self, xs):
        params, z = self.params, self.inducing
        with exact_f32_matmul():
            kus = rbf_kernel(params, z, xs)  # [m, S]
            tmp1 = _solve_lower(self._lu, kus)
            tmp2 = _solve_lower(self._lb, tmp1)
            mean = params.mean_const + tmp2.T @ self._c
        kss = _softplus(params.raw_outputscale)
        var = torch.clamp(
            kss - (tmp1 * tmp1).sum(dim=0) + (tmp2 * tmp2).sum(dim=0), min=1e-12
        )
        return mean, torch.sqrt(var)
