"""Zero-variance control variates (Mira, Solgi & Imparato 2013), counterpart
of klara_tpu/stats/zv.py: linear (``lzv``) and quadratic (``qzv``)
polynomial control variates built from the chain's ``gradlogtarget``, which
must be among the monitored fields.  The control-variate covariance block is
shared by all coordinates, so one solve gives every coefficient:
A = −Σ_zz⁻¹ Σ_{z,chain}.
"""

from __future__ import annotations

import torch

from klara_tpu_torch.stats._common import extract_f32


def _flatten(chain):
    if not hasattr(chain, "samples"):
        raise TypeError("pass a Chain with 'value' and 'gradlogtarget' monitored")
    # the estimators fit one set of coefficients to every draw: a meshed
    # chain's draws are gathered
    values = extract_f32(chain, "value", gather=True)
    grads = extract_f32(chain, "gradlogtarget", gather=True)
    return (values.reshape((-1,) + tuple(values.shape[2:])),
            grads.reshape((-1,) + tuple(grads.shape[2:])))


def _cov(a, b):
    """cov(a, b): a (n, p), b (n, q) -> (p, q), Bessel-corrected."""
    ac = a - a.mean(0, keepdim=True)
    bc = b - b.mean(0, keepdim=True)
    return ac.T @ bc / (a.shape[0] - 1)


def _inputs(chain, values, grads):
    if values is None:
        values, grads = _flatten(chain)
    values, grads = torch.as_tensor(values), torch.as_tensor(grads)
    if values.dim() == 1:
        values, grads = values[:, None], grads[:, None]
    return values, grads


def lzv(chain, values=None, grads=None):
    """Linear ZV estimator: (adjusted draws (n, d), coefficients)."""
    values, grads = _inputs(chain, values, grads)
    z = -0.5 * grads
    a = -torch.linalg.solve(_cov(z, z), _cov(z, values))
    return values + z @ a, a


def qzv(chain, values=None, grads=None):
    """Quadratic ZV estimator; the feature vector of a draw is
    [z, 2·z∘x − 1, {x_i z_j + x_j z_i}_{i<j}]."""
    values, grads = _inputs(chain, values, grads)
    d = values.shape[1]
    z = -0.5 * grads
    feats = [z, 2.0 * z * values - 1.0]
    i, j = torch.triu_indices(d, d, offset=1, device=values.device)
    if i.numel():
        feats.append(values[:, i] * z[:, j] + values[:, j] * z[:, i])
    qz = torch.cat(feats, dim=1)
    sqq = _cov(qz, qz)
    eye = torch.eye(sqq.shape[0], dtype=sqq.dtype, device=sqq.device)
    a = -torch.linalg.solve(sqq + 1e-10 * eye, _cov(qz, values))
    return values + qz @ a, a
