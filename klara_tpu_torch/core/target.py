"""Target (log-density) abstraction, batch-first.

Counterpart of klara_tpu/core/target.py.  Every function of a position takes
a leading chains axis: ``logdensity_fn(x)`` maps (C, D) to (C,), and
``logdensity_and_grad(x)`` returns (C,) and (C, D).  The JAX package writes
per-chain functions and vmaps them; here the batch is written out, so a
batched value+grad (the logreg kernel K1) plugs in directly as
``value_and_grad_fn``.

Missing derivatives come from autograd: ``torch.autograd.grad`` of the batch
sum for ``ad_mode='reverse'`` (rows are independent, so the sum's gradient
is each row's gradient), ``torch.func.jacfwd`` under ``torch.func.vmap`` for
``'forward'``.  The "tensor" is the negative Hessian of a log-density (the
observed Fisher information, SMMALA's metric), (C, D, D), and the "dtensor"
its derivative, (C, D, D, D).  Both come from ``torch.func`` transforms of the
per-chain function ``x -> fn(x[None])[0]`` under ``torch.func.vmap``, so they
go through ``logdensity_fn`` (a function of plain torch ops), never through
``value_and_grad_fn``, which may launch a kernel that cannot be traced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from klara_tpu_torch.utils import tracing

LogDensityFn = Callable[..., torch.Tensor]

# Value+grad evaluations through a factor (``through_factor``: the LGCP's
# and a whitened target's) in this process, replays included: a plain
# counter (reset it by assignment), replay-aware through
# ``jobs.graphs.launches_of`` and ``add_launches``.
FACTOR_EVALUATIONS = 0


def chain_sum(lp):
    """Sum a per-element log-density over every axis but the chains axis."""
    return lp.reshape(lp.shape[0], -1).sum(-1) if lp.dim() > 1 else lp


def _reverse_value_and_grad(fn, x):
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        value = fn(xr)
        (grad,) = torch.autograd.grad(value.sum(), xr)
    return value.detach(), grad


def _one(fn):
    """The per-chain form of a batched function."""
    return lambda xi: fn(xi.unsqueeze(0)).squeeze(0)


def _forward_grad(fn, x):
    return torch.func.vmap(torch.func.jacfwd(_one(fn)))(x)


def _neg_hessian_one(fn):
    hess = torch.func.hessian(_one(fn))
    return lambda xi: -hess(xi)


@dataclasses.dataclass(frozen=True)
class Target:
    """A (possibly unnormalised) batched log-density with derivative accessors.

    ``prior``, when given, has ``sample(generator, shape)`` (iid draws of the
    given shape) and ``logpdf(x)``; jobs draw initial values from it when run
    without ``x0``."""

    logdensity_fn: LogDensityFn
    dim: Optional[int] = None
    loglikelihood_fn: Optional[LogDensityFn] = None
    logprior_fn: Optional[LogDensityFn] = None
    prior: Optional[Any] = None
    grad_fn: Optional[Callable] = None
    value_and_grad_fn: Optional[Callable] = None
    # analytic overrides of the metric tensor (C, D, D) and its derivative
    tensor_fn: Optional[Callable] = None
    dtensor_fn: Optional[Callable] = None
    ad_mode: str = "reverse"
    name: str = "target"

    def __post_init__(self):
        if self.ad_mode not in ("reverse", "forward"):
            raise ValueError(
                f"ad_mode must be 'reverse' or 'forward', got {self.ad_mode!r}"
            )

    @classmethod
    def from_loglik_logprior(cls, loglikelihood_fn, logprior_fn, dim=None, **kwargs):
        """logtarget = loglikelihood + logprior."""

        def logdensity_fn(x):
            return loglikelihood_fn(x) + logprior_fn(x)

        return cls(
            logdensity_fn=logdensity_fn,
            loglikelihood_fn=loglikelihood_fn,
            logprior_fn=logprior_fn,
            dim=dim,
            **kwargs,
        )

    @classmethod
    def from_distribution(cls, dist, dim=None, **kwargs):
        """Target backed by an object with a ``logpdf``, summed per chain:
        over the coordinates of a univariate one, as it is for a
        multivariate one (MvNormal's logpdf is already (C,))."""
        if dim is None:
            dim = getattr(dist, "dim", None)
        return cls(logdensity_fn=lambda x: chain_sum(dist.logpdf(x)), dim=dim, **kwargs)

    def logdensity(self, x):
        return self.logdensity_fn(x)

    def loglikelihood(self, x):
        if self.loglikelihood_fn is None:
            raise ValueError("target has no loglikelihood decomposition")
        return self.loglikelihood_fn(x)

    def logprior(self, x):
        if self.logprior_fn is not None:
            return self.logprior_fn(x)
        if self.prior is not None:
            return chain_sum(self.prior.logpdf(x))
        raise ValueError("target has no logprior decomposition")

    def sample_prior(self, generator, n_chains: int):
        """Draw initial positions from ``prior``: (n_chains, dim) iid draws
        of a scalar prior, (n_chains, *event) draws of a multivariate one,
        and (n_chains,) per-chain scalars from a scalar prior when ``dim`` is
        unset (a univariate target; the job lifts them)."""
        if self.prior is None:
            raise ValueError(
                "target has no `prior` to draw initial values from; pass x0 "
                "explicitly or set Target(prior=...)"
            )
        if getattr(self.prior, "event_dims", 0) > 0 or self.dim is None:
            return self.prior.sample(generator, (n_chains,))
        return self.prior.sample(generator, (n_chains, self.dim))

    def grad(self, x):
        """∇ log π(x), (C, D)."""
        if self.grad_fn is not None:
            return self.grad_fn(x)
        if self.ad_mode == "forward":
            return _forward_grad(self.logdensity_fn, x)
        return _reverse_value_and_grad(self.logdensity_fn, x)[1]

    def logdensity_and_grad(self, x):
        """Fused value (C,) and gradient (C, D)."""
        if self.value_and_grad_fn is not None:
            return self.value_and_grad_fn(x)
        if self.grad_fn is not None:
            return self.logdensity_fn(x), self.grad_fn(x)
        if self.ad_mode == "forward":
            return self.logdensity_fn(x), _forward_grad(self.logdensity_fn, x)
        return _reverse_value_and_grad(self.logdensity_fn, x)

    # -- likelihood / prior derivative accessors: with ``grad``, ``tensor``
    # and ``dtensor`` they back the 13 monitored slots
    # {log, gradlog, tensorlog, dtensorlog} × {likelihood, prior, target} + value

    def _loglikelihood_callable(self) -> LogDensityFn:
        if self.loglikelihood_fn is None:
            raise ValueError("target has no loglikelihood decomposition")
        return self.loglikelihood_fn

    def _logprior_callable(self) -> LogDensityFn:
        if self.logprior_fn is not None:
            return self.logprior_fn
        if self.prior is not None:
            return lambda x: chain_sum(self.prior.logpdf(x))
        raise ValueError("target has no logprior decomposition")

    def _ad_grad(self, fn, x):
        if self.ad_mode == "forward":
            return _forward_grad(fn, x)
        return _reverse_value_and_grad(fn, x)[1]

    def grad_loglikelihood(self, x):
        """∇ log L(x), (C, D)."""
        return self._ad_grad(self._loglikelihood_callable(), x)

    def grad_logprior(self, x):
        """∇ log p(x), (C, D)."""
        return self._ad_grad(self._logprior_callable(), x)

    def _tensor_one(self):
        if self.tensor_fn is not None:
            return _one(self.tensor_fn)
        return _neg_hessian_one(self.logdensity_fn)

    def tensor(self, x):
        """Metric tensor G(x) = −Hessian of the log-target, (C, D, D)."""
        if self.tensor_fn is not None:
            return self.tensor_fn(x)
        return torch.func.vmap(_neg_hessian_one(self.logdensity_fn))(x)

    def tensor_loglikelihood(self, x):
        """−Hessian of log L, (C, D, D)."""
        return torch.func.vmap(_neg_hessian_one(self._loglikelihood_callable()))(x)

    def tensor_logprior(self, x):
        """−Hessian of log p, (C, D, D)."""
        return torch.func.vmap(_neg_hessian_one(self._logprior_callable()))(x)

    def dtensor(self, x):
        """Derivative of the metric tensor, (C, D, D, D): entry [c, i, j, k]
        is ∂G_ij/∂x_k."""
        if self.dtensor_fn is not None:
            return self.dtensor_fn(x)
        return torch.func.vmap(torch.func.jacfwd(self._tensor_one()))(x)

    def dtensor_loglikelihood(self, x):
        return torch.func.vmap(
            torch.func.jacfwd(_neg_hessian_one(self._loglikelihood_callable()))
        )(x)

    def dtensor_logprior(self, x):
        return torch.func.vmap(
            torch.func.jacfwd(_neg_hessian_one(self._logprior_callable()))
        )(x)

    def logdensity_grad_tensor(self, x):
        """Value (C,), gradient (C, D) and tensor (C, D, D): value and
        gradient from ``logdensity_and_grad`` (the fused kernel where the
        target has one), the tensor from ``tensor``."""
        if self.tensor_fn is not None and self.grad_fn is not None:
            return self.logdensity_fn(x), self.grad_fn(x), self.tensor_fn(x)
        value, grad = self.logdensity_and_grad(x)
        return value, grad, self.tensor(x)

    def with_name(self, name: str) -> "Target":
        return dataclasses.replace(self, name=name)


def bounded_target(target: Target, lower=None, upper=None) -> Target:
    """Positions outside [lower, upper] get -inf density.  As in the JAX
    package only ``logdensity_fn`` is wrapped: analytic derivative
    overrides pass through unchanged."""
    lo = -torch.inf if lower is None else lower
    hi = torch.inf if upper is None else upper

    def logdensity_fn(x):
        raw = target.logdensity_fn(x)
        ok = ((x >= lo) & (x <= hi)).all(-1)
        return torch.where(ok, raw, torch.full_like(raw, -torch.inf))

    return dataclasses.replace(target, logdensity_fn=logdensity_fn)


def through_factor(value_and_grad, chol, shift=None, standard_normal: bool = False):
    """The fused value+grad in y of a function f of x = shift + L y (L =
    ``chol``, lower-triangular), from f's fused ``value_and_grad`` in x.

    Row-wise for a (C, D) batch: x = y Lᵀ (+ ``shift``, a (D,) tensor, in
    the product's epilogue) and grad_y = grad_x L, two (C, D)×(D, D)
    products an evaluation around f's.  With ``standard_normal`` a N(0, I)
    log-density in y is added: −½‖y‖² to the value and −y to the gradient,
    the latter in the second product's epilogue.  Returns (value_and_grad
    in y, the map y -> x).

    Each evaluation adds one to ``FACTOR_EVALUATIONS`` and its host time
    to the tracer's timed counter ``factor.host_ns``, a span ``factor``
    while recording (a graph replay runs neither)."""
    chol = torch.as_tensor(chol)
    chol_t = chol.T.contiguous()

    def to_x(y):
        return y @ chol_t if shift is None else torch.addmm(shift, y, chol_t)

    def value_and_grad_fn(y):
        global FACTOR_EVALUATIONS
        with tracing.timed("factor.host_ns", "factor"):
            v, g = value_and_grad(to_x(y))
            if not standard_normal:
                out = v, g @ chol
            else:
                out = v - 0.5 * (y * y).sum(-1), torch.addmm(y, g, chol, beta=-1.0)
        FACTOR_EVALUATIONS += 1
        return out

    return value_and_grad_fn, to_x


def whiten_target(target: Target, chol) -> Target:
    """Reparameterise ``target`` by x = L y (L = ``chol``, lower-triangular).

    Row-wise for a (C, D) batch: x = y Lᵀ and grad_y = grad_x L, two plain
    (C, D)×(D, D) matmuls per evaluation around the inner target's fused
    value+grad (K1 for the logreg target): ``through_factor``."""
    chol = torch.as_tensor(chol)
    chol_t = chol.T.contiguous()
    value_and_grad_fn, to_x = through_factor(target.logdensity_and_grad, chol)

    def logdensity_fn(y):
        return target.logdensity(to_x(y))

    loglik = (
        (lambda y: target.loglikelihood_fn(to_x(y)))
        if target.loglikelihood_fn is not None
        else None
    )
    logprior = (
        (lambda y: target.logprior_fn(to_x(y)))
        if target.logprior_fn is not None
        else None
    )
    # the analytic tensor re-expressed in y: H_y = Lᵀ H_x L
    tensor = (
        (lambda y: chol_t @ target.tensor_fn(to_x(y)) @ chol)
        if target.tensor_fn is not None
        else None
    )
    prior = _WhitenedPrior(target.prior, chol) if target.prior is not None else None
    return Target(
        logdensity_fn=logdensity_fn,
        dim=target.dim,
        loglikelihood_fn=loglik,
        logprior_fn=logprior,
        prior=prior,
        value_and_grad_fn=value_and_grad_fn,
        tensor_fn=tensor,
        ad_mode=target.ad_mode,
        name=f"{target.name}_whitened",
    )


class _WhitenedPrior:
    """x-space prior seen through y = L⁻¹x: draws are whitened base draws;
    logpdf differs from the x-space one by the constant log|det L|."""

    def __init__(self, base, chol):
        self.base = base
        self.chol = chol
        self.event_dims = getattr(base, "event_dims", 0)

    def sample(self, generator, shape):
        x = torch.as_tensor(self.base.sample(generator, shape), dtype=self.chol.dtype)
        # rows are draws: y = (L⁻¹ xᵀ)ᵀ
        return torch.linalg.solve_triangular(self.chol, x.T, upper=False).T

    def logpdf(self, y):
        return self.base.logpdf(y @ self.chol.T)
