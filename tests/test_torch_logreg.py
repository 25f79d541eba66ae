"""K1's plain PyTorch version (klara_tpu_torch.ops.logreg) against the JAX
package's batched logreg value+grad: the XLA path, the Pallas kernel body in
interpret mode, and the autodiff oracle.  Inputs come from numpy
``default_rng``.  Both sides compute in f32; tolerances cover a different
summation order and, against the Pallas path, its padded-row log 2
correction."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from klara_tpu.ops.logreg import _xla_value_grad_batched, fused_logreg_value_grad
from klara_tpu_torch.ops import logreg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(C=5, D=7, N=33, lam=10.0, seed=0):
    rng = np.random.default_rng(seed)
    P = (rng.standard_normal((C, D)) * 0.5).astype(np.float32)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)
    return P, X, y, lam


def _port(P, X, y, lam):
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    v, g = logreg.logreg_value_grad(torch.from_numpy(P), Xt, Xt.T @ yt, lam)
    return v.numpy(), g.numpy()


def _oracle(P, X, y, lam):
    D = X.shape[1]
    X, y = jnp.asarray(X), jnp.asarray(y)

    def logdensity(p):
        logits = X @ p
        return (
            jnp.dot(logits, y)
            - jnp.sum(jax.nn.softplus(logits))
            - 0.5 * jnp.dot(p, p) / lam
            - 0.5 * D * jnp.log(2.0 * jnp.pi * lam)
        )

    v, g = jax.vmap(jax.value_and_grad(logdensity))(jnp.asarray(P))
    return np.asarray(v), np.asarray(g)


@pytest.mark.parametrize("shape", [(5, 7, 33), (16, 3, 50), (64, 100, 256)])
def test_plain_matches_xla_batched(shape):
    # f32 on both sides, different reduction order: rtol 1e-5 on values
    # of size ~N, gradients atol 1e-4
    C, D, N = shape
    P, X, y, lam = _problem(C, D, N, seed=C + D)
    v_ref, g_ref = _xla_value_grad_batched(jnp.asarray(P), jnp.asarray(X), jnp.asarray(y), lam)
    v, g = _port(P, X, y, lam)
    np.testing.assert_allclose(v, np.asarray(v_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=1e-5, atol=1e-4)


def test_plain_matches_pallas_interpret():
    """The Pallas kernel body (interpret mode) at the padding-forcing shape:
    C, D and N all padded, more than one data tile."""
    P, X, y, lam = _problem(C=5, D=7, N=300)
    v_ref, g_ref = fused_logreg_value_grad(
        jnp.asarray(P), jnp.asarray(X), jnp.asarray(y), lam,
        tile_c=8, tile_n=128, interpret=True,
    )
    v, g = _port(P, X, y, lam)
    # the Pallas value subtracts n_pad·log 2 after summing padded rows
    np.testing.assert_allclose(v, np.asarray(v_ref), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=2e-5, atol=1e-4)


def test_plain_matches_autodiff_oracle():
    P, X, y, lam = _problem(C=5, D=7, N=300, seed=3)
    v_ref, g_ref = _oracle(P, X, y, lam)
    v, g = _port(P, X, y, lam)
    np.testing.assert_allclose(v, v_ref, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(g, g_ref, rtol=2e-5, atol=1e-4)


def test_cpu_call_launches_no_kernel():
    before = logreg.KERNEL_LAUNCHES
    _port(*_problem())
    assert logreg.KERNEL_LAUNCHES == before == 0


def test_import_needs_no_nvcc_or_triton():
    """A fresh interpreter with no nvcc on PATH imports the package and runs
    the CPU path without importing triton or building anything."""
    code = (
        "import sys, torch\n"
        "had_jax = 'jax' in sys.modules\n"
        "import klara_tpu_torch, klara_tpu_torch.ops as ops\n"
        "from klara_tpu_torch.ops import _build\n"
        "P = torch.zeros(2, 3); X = torch.ones(4, 3)\n"
        "ops.logreg_value_grad(P, X, X.T @ torch.ones(4), 1.0)\n"
        "assert 'triton' not in sys.modules\n"
        "assert had_jax or 'jax' not in sys.modules\n"
        "assert _build._lib is None\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_checks_refuse_what_k1_does_not_take():
    """The wrapper's checks, which run before any build or launch."""
    with pytest.raises(ValueError, match="1 <= D <= 128"):
        logreg._check(torch.zeros(2, 129), torch.zeros(4, 129), torch.zeros(129))
    with pytest.raises(ValueError, match="expected the CUDA device"):
        logreg._check(torch.zeros(2, 3), torch.zeros(4, 3), torch.zeros(3))
    with pytest.raises(ValueError, match="dims disagree"):
        logreg._check(torch.zeros(2, 3), torch.zeros(4, 2), torch.zeros(3))
