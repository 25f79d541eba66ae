"""Distributions: logpdf / sample / mean, batch-first (counterpart of
klara_tpu/distributions/core.py).

Each distribution is a frozen dataclass whose parameters are Python numbers
or tensors that broadcast like numpy arrays (right-aligned), so a Gibbs full
conditional built from batch-first values carries the chains axis in its
parameters.  ``sample(rng, shape=())`` draws from ``rng``: a
``torch.Generator`` (on its device), or a ``KeyedStream``
(``ops.keyed``: per-chain keyed draws, the chains on axis 0 of the sample
shape; what ``GibbsJob`` and ``MH`` hand it, so that a rank draws only its
own chains).  A keyed Gamma with a scalar shape parameter and a vector rate
draws one element per chain, as the JAX package's per-chain key does: the
element counter runs over the per-chain draw, not over the broadcast value.

Sample shapes follow the JAX package's rule for each class (Normal: the
broadcast of loc and scale; Gamma, InverseGamma, Beta: the shape parameter
alone; Uniform, Exponential, Laplace: ``shape`` alone), with ``shape``
broadcast against that rule's shape instead of replacing it.  The two agree
wherever the JAX call is valid; the broadcast lets a job pass (C, 1, …) and
get one independent draw per chain with the JAX per-chain shape inside it.
MvNormal and Dirichlet draw at the broadcast of ``shape`` and their
parameters' batch shape.  ``event_dims`` is the number of trailing axes one
draw spans (1 for MvNormal and Dirichlet); ``draw_per_chain`` uses it to
draw once per chain for a batch-first value.

``noise`` replays the standard draw a sample transforms (standard normal,
standard gamma, U(0, 1), standard exponential, the Laplace base draw); tests
use it to feed another package's draws.  Bernoulli, Binomial and Poisson
return int32, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from klara_tpu_torch.ops.keyed import KeyedStream


def _dist(cls):
    return dataclasses.dataclass(frozen=True)(cls)


def _shape(p):
    return tuple(p.shape) if torch.is_tensor(p) else ()


def _fdtype(*params):
    for p in params:
        if torch.is_tensor(p) and p.is_floating_point():
            return p.dtype
    return torch.get_default_dtype()


def _t(p, like):
    """A parameter as a tensor beside ``like`` (a fill, not a host copy)."""
    if torch.is_tensor(p):
        return p
    dt = like.dtype if like.is_floating_point() else torch.get_default_dtype()
    return torch.full((), p, dtype=dt, device=like.device)


def _tensor(v):
    """A result that may be a Python number, as a tensor."""
    if torch.is_tensor(v):
        return v
    return torch.tensor(v, dtype=torch.get_default_dtype())


def _draw_shape(shape, *param_shapes):
    return torch.broadcast_shapes(tuple(shape), *param_shapes)


def _kw(generator, dtype):
    return dict(generator=generator, device=generator.device, dtype=dtype)


def _keyed(rng) -> bool:
    return isinstance(rng, KeyedStream)


def _rand(rng, shape, dtype):
    """U(0, 1) of ``shape`` from a generator or a keyed stream."""
    if _keyed(rng):
        return rng.uniform(shape, dtype)
    return torch.rand(tuple(shape), **_kw(rng, dtype))


def _standard_gamma(generator, a, shape, dtype):
    if _keyed(generator):
        return generator.standard_gamma(a, shape, dtype)
    if torch.is_tensor(a):
        alpha = a.to(dtype).expand(shape).contiguous()
    else:
        alpha = torch.full(shape, a, dtype=dtype, device=generator.device)
    return torch._standard_gamma(alpha, generator=generator)


def _ndtr(x):
    """Standard normal CDF with jax.scipy.special.ndtr's branches: erfc in
    the tails keeps the lower tail's relative precision (torch's ndtr
    returns 0 below about −8.3)."""
    w = x * (0.5 * math.sqrt(2.0))
    z = torch.abs(w)
    y = torch.where(z < 0.5 * math.sqrt(2.0), 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _norm_logpdf(x, loc, scale):
    # jax.scipy.stats.norm.logpdf's order of operations
    s2 = torch.square(scale)
    return (torch.log(2 * math.pi * s2) + torch.square(x - loc) / s2) / -2.0


class Distribution:
    """Marker base class (duck-typed: logpdf/sample/mean)."""

    event_dims = 0

    def logpdf(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def sample(self, rng, shape=()):  # pragma: no cover - interface
        """A draw of ``shape``.  ``rng`` is a ``torch.Generator`` or, where
        ``GibbsJob`` or ``MH`` hand it (a conditional, a proposal
        distribution), a ``KeyedStream`` (``ops.keyed``), which is not a
        generator: a subclass draws through its methods ``uniform(shape,
        dtype)``, ``normal(shape, dtype)``, ``standard_gamma(alpha, shape,
        dtype)``, ``poisson(rate, shape, dtype)`` and ``binomial(count,
        prob, shape, dtype)``, each with the chains on axis 0 of ``shape``
        (float32 or float64; parameters on the stream's device)."""
        raise NotImplementedError


# --------------------------------------------------------------------------
# Continuous univariate
# --------------------------------------------------------------------------


@_dist
class Normal(Distribution):
    loc: Any = 0.0
    scale: Any = 1.0

    def logpdf(self, x):
        return _norm_logpdf(x, _t(self.loc, x), _t(self.scale, x))

    def sample(self, rng, shape=(), noise=None):
        if noise is None:
            shape = _draw_shape(shape, _shape(self.loc), _shape(self.scale))
            dt = _fdtype(self.loc, self.scale)
            noise = rng.normal(shape, dt) if _keyed(rng) else torch.randn(shape, **_kw(rng, dt))
        return self.loc + self.scale * noise

    def _bshape(self):
        return torch.broadcast_shapes(_shape(self.loc), _shape(self.scale))

    def mean(self):
        return torch.broadcast_to(_tensor(self.loc), self._bshape())

    def var(self):
        return torch.broadcast_to(torch.square(_tensor(self.scale)), self._bshape())


@_dist
class LogNormal(Distribution):
    mu: Any = 0.0
    sigma: Any = 1.0

    def logpdf(self, x):
        safe = torch.where(x > 0, x, 1.0)
        lp = -torch.log(safe) + _norm_logpdf(torch.log(safe), _t(self.mu, x), _t(self.sigma, x))
        return torch.where(x > 0, lp, -math.inf)

    def sample(self, rng, shape=(), noise=None):
        return torch.exp(Normal(self.mu, self.sigma).sample(rng, shape, noise))

    def mean(self):
        return torch.exp(_tensor(self.mu) + 0.5 * torch.square(_tensor(self.sigma)))


@_dist
class Uniform(Distribution):
    low: Any = 0.0
    high: Any = 1.0

    def logpdf(self, x):
        low, high = _t(self.low, x), _t(self.high, x)
        inside = (x >= low) & (x <= high)
        return torch.where(inside, -torch.log(high - low), -math.inf)

    def sample(self, rng, shape=(), noise=None):
        if noise is None:
            noise = _rand(rng, shape, _fdtype(self.low, self.high))
        return self.low + (self.high - self.low) * noise

    def mean(self):
        return _tensor(0.5 * (self.low + self.high))


@_dist
class Exponential(Distribution):
    rate: Any = 1.0

    def logpdf(self, x):
        rate = _t(self.rate, x)
        return torch.where(x >= 0, torch.log(rate) - rate * x, -math.inf)

    def sample(self, rng, shape=(), noise=None):
        if noise is None:
            if _keyed(rng):  # −log U, U on (0, 1): finite and positive
                noise = -torch.log(rng.uniform(shape, _fdtype(self.rate)))
            else:
                noise = torch.empty(
                    tuple(shape), dtype=_fdtype(self.rate), device=rng.device
                ).exponential_(generator=rng)
        return noise / self.rate

    def mean(self):
        return _tensor(1.0 / self.rate)


@_dist
class Laplace(Distribution):
    loc: Any = 0.0
    scale: Any = 1.0

    def logpdf(self, x):
        loc, scale = _t(self.loc, x), _t(self.scale, x)
        return -(torch.abs(x - loc) / scale + torch.log(2.0 * scale))

    def sample(self, rng, shape=(), noise=None):
        if noise is None:
            dt = _fdtype(self.loc, self.scale)
            if _keyed(rng):  # 2U − 1 on (−1, 1)
                u = 2.0 * rng.uniform(shape, dt) - 1.0
            else:
                lo = -1.0 + torch.finfo(dt).eps / 2  # jax.random.laplace's open interval
                u = lo + (1.0 - lo) * torch.rand(tuple(shape), **_kw(rng, dt))
            noise = torch.sign(u) * torch.log1p(-torch.abs(u))
        return self.loc + self.scale * noise

    def mean(self):
        return _tensor(self.loc)


@_dist
class Gamma(Distribution):
    """Shape/rate parameterisation: mean = shape / rate."""

    shape: Any = 1.0
    rate: Any = 1.0

    def logpdf(self, x):
        a, r = _t(self.shape, x), _t(self.rate, x)
        safe = torch.where(x > 0, x, 1.0)
        lp = a * torch.log(r) - torch.lgamma(a) + (a - 1.0) * torch.log(safe) - r * safe
        return torch.where(x > 0, lp, -math.inf)

    def sample(self, rng, shape=(), noise=None):
        if noise is None:
            noise = _standard_gamma(rng, self.shape, _draw_shape(shape, _shape(self.shape)),
                                    _fdtype(self.shape, self.rate))
        return noise / self.rate

    def mean(self):
        return _tensor(self.shape / self.rate)


@_dist
class InverseGamma(Distribution):
    shape: Any = 1.0
    scale: Any = 1.0

    def logpdf(self, x):
        a, b = _t(self.shape, x), _t(self.scale, x)
        safe = torch.where(x > 0, x, 1.0)
        lp = a * torch.log(b) - torch.lgamma(a) - (a + 1.0) * torch.log(safe) - b / safe
        return torch.where(x > 0, lp, -math.inf)

    def sample(self, rng, shape=(), noise=None):
        if noise is None:
            noise = _standard_gamma(rng, self.shape, _draw_shape(shape, _shape(self.shape)),
                                    _fdtype(self.shape, self.scale))
        return self.scale / noise

    def mean(self):
        return _tensor(self.scale / (self.shape - 1.0))


@_dist
class Beta(Distribution):
    a: Any = 1.0
    b: Any = 1.0

    def logpdf(self, x):
        a, b = _t(self.a, x), _t(self.b, x)
        betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        lp = -betaln + torch.xlogy(a - 1.0, x) + torch.special.xlog1py(b - 1.0, -x)
        lp = torch.where((x > 1) | (x < 0), -math.inf, lp)
        return torch.where((a <= 0) | (b <= 0), math.nan, lp)

    def sample(self, rng, shape=()):
        shape = _draw_shape(shape, _shape(self.a))
        dt = _fdtype(self.a, self.b)
        ga = _standard_gamma(rng, self.a, shape, dt)
        # a keyed stream's second gamma draw takes part 1 of its counter
        gb = _standard_gamma(rng.at(part=1) if _keyed(rng) else rng, self.b, shape, dt)
        return ga / (ga + gb)

    def mean(self):
        return _tensor(self.a / (self.a + self.b))


def truncated_standard_normal(a, b, noise):
    """z ~ N(0, 1) truncated to [a, b] from ``noise`` ~ U(0, 1), by inverting
    the CDF in float64 (the result is float64) on the side of the mode nearer
    the interval, where Φ keeps its precision; an interval past Φ's float64
    range returns its finite end."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    flip = a > 0  # sample −z on [−b, −a]: Φ is exact near 0, not near 1
    lo, hi = torch.where(flip, -b, a), torch.where(flip, -a, b)
    plo, phi = _ndtr(lo), _ndtr(hi)
    p = plo + noise.to(torch.float64) * (phi - plo)
    tiny = torch.finfo(torch.float64).tiny
    z = torch.special.ndtri(p.clamp(tiny, 1.0 - 2.0**-53))
    z = torch.where(flip, -z, z)
    z = torch.minimum(torch.maximum(z, a), b)
    return torch.where(torch.isfinite(z), z, torch.where(torch.isfinite(a), a, b))


@_dist
class TruncatedNormal(Distribution):
    """Normal(loc, scale) truncated to [low, high].

    ``logpdf`` is normalised (it subtracts ``lognormaliser``), so use it with
    ``MH(symmetric=False)``, not ``MH(normalised=False)``.  ``sample``
    inverts the CDF in float64 on the side of the mode nearer the interval
    (where Φ keeps its precision); an interval past Φ's float64 range
    returns its finite end.
    """

    loc: Any = 0.0
    scale: Any = 1.0
    low: Any = -math.inf
    high: Any = math.inf

    def _alpha_beta(self):
        return (self.low - self.loc) / self.scale, (self.high - self.loc) / self.scale

    def lognormaliser(self):
        a, b = (_tensor(v) for v in self._alpha_beta())
        return torch.log(_ndtr(b) - _ndtr(a))

    def logpdf(self, x):
        low, high = _t(self.low, x), _t(self.high, x)
        inside = (x >= low) & (x <= high)
        lp = _norm_logpdf(x, _t(self.loc, x), _t(self.scale, x)) - self.lognormaliser().to(x.device)
        return torch.where(inside, lp, -math.inf)

    def sample(self, rng, shape=(), noise=None):
        dt = _fdtype(self.loc, self.scale, self.low, self.high)
        shape = _draw_shape(shape, _shape(self.loc))
        if noise is None:
            noise = _rand(rng, shape, dt)
        a, b = (torch.as_tensor(v, device=noise.device) for v in self._alpha_beta())
        return (self.loc + self.scale * truncated_standard_normal(a, b, noise)).to(dt)

    def mean(self):
        a, b = (_tensor(v) for v in self._alpha_beta())
        pdf = lambda v: torch.exp(-0.5 * torch.square(v)) / math.sqrt(2 * math.pi)  # noqa: E731
        num = pdf(a) - pdf(b)
        den = _ndtr(b) - _ndtr(a)
        return self.loc + self.scale * num / den


def draw_per_chain(dist, like, rng, noise=None):
    """One draw per chain from ``dist`` at the shape and dtype of the
    batch-first value ``like`` (C, ...): the sample shape (C, 1, …) keeps
    each class's shape rule within a chain.  ``rng`` is a generator or a
    ``KeyedStream`` for the C chains of ``like`` (on a mesh: the rank's
    block, named by their global indices); ``noise`` replays the standard
    draw."""
    shape = (like.shape[0],) + (1,) * (like.dim() - 1 - dist.event_dims)
    if noise is None:
        try:
            draw = dist.sample(rng, shape)
        except (TypeError, AttributeError) as e:
            if not _keyed(rng) or type(dist).__module__ == __name__:
                raise
            raise TypeError(
                f"{type(dist).__name__}.sample was handed a KeyedStream, not a "
                "torch.Generator, and could not use it: draw through the stream's "
                "uniform, normal, standard_gamma, poisson or binomial (see "
                "Distribution.sample)") from e
    else:
        draw = dist.sample(rng, shape, noise=noise)
    return draw.reshape(like.shape).to(like.dtype)


def lognormalise_truncated_normal(loc, scale, low, high):
    """log P(low <= N(loc, scale) <= high)."""
    return TruncatedNormal(loc, scale, low, high).lognormaliser()


# --------------------------------------------------------------------------
# Continuous multivariate
# --------------------------------------------------------------------------


@_dist
class MvNormal(Distribution):
    """Multivariate normal from its lower Cholesky factor; ``loc`` (..., D),
    ``chol`` (D, D) or batched (..., D, D)."""

    loc: Any
    chol: Any

    event_dims = 1

    @classmethod
    def from_cov(cls, loc, cov):
        loc = torch.as_tensor(loc)
        cov = torch.as_tensor(cov, dtype=loc.dtype, device=loc.device)
        if cov.dim() == 0:
            cov = torch.eye(loc.shape[-1], dtype=loc.dtype, device=loc.device) * cov
        elif cov.dim() == 1:
            cov = torch.diag(cov)
        return cls(loc=loc, chol=torch.linalg.cholesky(cov))

    @property
    def dim(self):
        return self.loc.shape[-1]

    def logpdf(self, x):
        diff = x - self.loc
        w = torch.linalg.solve_triangular(self.chol, diff.unsqueeze(-1), upper=False).squeeze(-1)
        logdet = torch.log(torch.abs(torch.diagonal(self.chol, dim1=-2, dim2=-1))).sum(-1)
        return -0.5 * torch.square(w).sum(-1) - logdet - 0.5 * self.dim * math.log(2.0 * math.pi)

    def sample(self, rng, shape=(), noise=None):
        if noise is None:
            batch = _draw_shape(shape, tuple(self.loc.shape[:-1]), tuple(self.chol.shape[:-2]))
            if _keyed(rng):
                noise = rng.normal(batch + (self.dim,), self.loc.dtype)
            else:
                noise = torch.randn(batch + (self.dim,), **_kw(rng, self.loc.dtype))
        return self.loc + torch.matmul(self.chol, noise.unsqueeze(-1)).squeeze(-1)

    def mean(self):
        return self.loc


@_dist
class Dirichlet(Distribution):
    """Components on the last axis; ``logpdf`` takes all K components or
    the first K − 1."""

    alpha: Any

    event_dims = 1

    def logpdf(self, x):
        alpha = self.alpha
        if x.shape[-1] == alpha.shape[-1] - 1:
            x = torch.cat([x, 1.0 - x.sum(-1, keepdim=True)], dim=-1)
        norm = torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))
        lp = torch.xlogy(alpha - 1.0, x).sum(-1) - norm
        simplex = (x > 0).all(-1) & (torch.abs(x.sum(-1) - 1.0) < 1e-6)
        return torch.where(simplex, lp, -math.inf)

    def sample(self, rng, shape=()):
        k = self.alpha.shape[-1]
        shape = _draw_shape(shape, tuple(self.alpha.shape[:-1])) + (k,)
        g = _standard_gamma(rng, self.alpha, shape, self.alpha.dtype)
        return g / g.sum(-1, keepdim=True)

    def mean(self):
        return self.alpha / self.alpha.sum(-1, keepdim=True)


# --------------------------------------------------------------------------
# Discrete
# --------------------------------------------------------------------------


@_dist
class Bernoulli(Distribution):
    p: Any = 0.5

    def logpdf(self, x):
        p = _t(self.p, x)
        return torch.where(x == 1, torch.log(p), torch.log1p(-p))

    def sample(self, rng, shape=()):
        shape = _draw_shape(shape, _shape(self.p))
        return (_rand(rng, shape, _fdtype(self.p)) < self.p).to(torch.int32)

    def mean(self):
        return _tensor(self.p)


@_dist
class Binary(Distribution):
    """Two-point distribution: P(X=b) = p, P(X=a) = 1-p."""

    a: Any = 0
    b: Any = 1
    p: Any = 0.5

    def succprob(self):
        return self.p

    def failprob(self):
        return 1.0 - self.p

    def logpdf(self, x):
        p = _t(self.p, x)
        lp = torch.where(x == self.b, torch.log(p), torch.log1p(-p))
        return torch.where((x == self.a) | (x == self.b), lp, -math.inf)

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def sample(self, rng, shape=()):
        shape = _draw_shape(shape, _shape(self.p))
        coin = _rand(rng, shape, _fdtype(self.p)) < self.p
        a, b = (torch.as_tensor(v, device=rng.device) for v in (self.a, self.b))
        out = torch.where(coin, b, a)
        # JAX's 32-bit defaults: Python ints give int32, floats f32
        if out.dtype == torch.int64:
            return out.to(torch.int32)
        if out.dtype == torch.float64:
            return out.to(torch.float32)
        return out

    def mean(self):
        return _tensor(self.p * self.b + (1.0 - self.p) * self.a)


@_dist
class Binomial(Distribution):
    n: Any = 1
    p: Any = 0.5

    def logpdf(self, x):
        dt = torch.get_default_dtype()
        n = torch.as_tensor(self.n, device=x.device).to(dt)
        xf = x.to(dt)
        p = _t(self.p, xf)
        comb = torch.lgamma(n + 1) - torch.lgamma(xf + 1) - torch.lgamma(n - xf + 1)
        lp = comb + xf * torch.log(p) + (n - xf) * torch.log1p(-p)
        return torch.where((xf >= 0) & (xf <= n), lp, -math.inf)

    def sample(self, rng, shape=()):
        shape = _draw_shape(shape, _shape(self.n), _shape(self.p))
        dt = torch.get_default_dtype()
        if _keyed(rng):
            return rng.binomial(self.n, self.p, shape, dt).to(torch.int32)
        kw = dict(dtype=dt, device=rng.device)
        count = torch.as_tensor(self.n, **kw).expand(shape).contiguous()
        prob = torch.as_tensor(self.p, **kw).expand(shape).contiguous()
        return torch.binomial(count, prob, generator=rng).to(torch.int32)

    def mean(self):
        return _tensor(self.n * self.p)


@_dist
class Poisson(Distribution):
    rate: Any = 1.0

    def logpdf(self, x):
        xf = x.to(torch.get_default_dtype())
        rate = _t(self.rate, xf)
        lp = xf * torch.log(rate) - rate - torch.lgamma(xf + 1)
        return torch.where(xf >= 0, lp, -math.inf)

    def sample(self, rng, shape=()):
        shape = _draw_shape(shape, _shape(self.rate))
        if _keyed(rng):
            return rng.poisson(self.rate, shape, torch.get_default_dtype()).to(torch.int32)
        kw = dict(dtype=torch.get_default_dtype(), device=rng.device)
        rate = torch.as_tensor(self.rate, **kw).expand(shape).contiguous()
        return torch.poisson(rate, generator=rng).to(torch.int32)

    def mean(self):
        return _tensor(self.rate)
