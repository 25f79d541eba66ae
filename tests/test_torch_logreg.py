"""K1's plain PyTorch version (klara_tpu_torch.ops.logreg) against the JAX
package's batched logreg value+grad: the XLA path, the Pallas kernel body in
interpret mode, and the autodiff oracle.  Inputs come from numpy
``default_rng``.  Both sides compute in f32; tolerances cover a different
summation order and, against the Pallas path, its padded-row log 2
correction."""

import dataclasses
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
from klara_tpu_torch.utils import tracing

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
    def launches():
        return tracing.counters().get("ops.logreg.KERNEL_LAUNCHES", (0, 0))[0]

    before = launches()
    _port(*_problem())
    assert launches() == before


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
        "assert _build._libs == {}\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_cuda_checks_refuse_what_k1_does_not_take():
    """The wrapper's checks, which run before any build or launch."""
    with pytest.raises(ValueError, match="D >= 1"):
        logreg._check(torch.zeros(2, 0), torch.zeros(4, 0), torch.zeros(0))
    # wider than the tensor-core form's 128 columns is K1's wide form, which
    # only the device refuses here
    with pytest.raises(ValueError, match="expected the CUDA device"):
        logreg._check(torch.zeros(2, 129), torch.zeros(4, 129), torch.zeros(129))
    with pytest.raises(ValueError, match="expected the CUDA device"):
        logreg._check(torch.zeros(2, 3), torch.zeros(4, 3), torch.zeros(3))
    with pytest.raises(ValueError, match="dims disagree"):
        logreg._check(torch.zeros(2, 3), torch.zeros(4, 2), torch.zeros(3))


# ------------------------------------------------- the kernel's TF32 arithmetic
def _f64_oracle(P, X, y, lam):
    Pd, Xd = torch.from_numpy(P).double(), torch.from_numpy(X).double()
    v, g = logreg.logreg_value_grad_reference(Pd, Xd, Xd.T @ torch.from_numpy(y).double(), lam)
    return v.numpy(), g.numpy()


def _split(P, X, y, lam, passes):
    v, g = logreg.logreg_value_grad_split(torch.from_numpy(P), torch.from_numpy(X),
                                          torch.from_numpy(y), lam, passes=passes)
    return v.numpy(), g.numpy()


@pytest.mark.parametrize("seed", [11, 12])
def test_three_pass_split_is_f32_grade(seed):
    """hi·hi + hi·lo + lo·hi on TF32-rounded operands, f32 sums, the
    log-likelihood summed row by row from the split logits as in the kernel,
    against a float64 oracle: as close as f32 arithmetic gets (rtol 2e-6;
    atol 1e-4 for the f32 sums of 256 terms and for gradient entries near 0)."""
    P, X, y, lam = _problem(64, 100, 256, seed=seed)
    v_ref, g_ref = _f64_oracle(P, X, y, lam)
    v, g = _split(P, X, y, lam, passes=3)
    np.testing.assert_allclose(v, v_ref, rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(g, g_ref, rtol=2e-6, atol=1e-4)


def test_one_pass_split_keeps_three_digits():
    """A single TF32 pass is not f32-grade (outside rtol 1e-5) and keeps
    about three decimal digits (inside rtol 5e-3; atol 2e-2 for gradient
    entries that are small differences of sums of size ~10)."""
    P, X, y, lam = _problem(64, 100, 256, seed=11)
    v_ref, g_ref = _f64_oracle(P, X, y, lam)
    v, g = _split(P, X, y, lam, passes=1)
    assert not np.allclose(v, v_ref, rtol=1e-5, atol=0)
    assert not np.allclose(g, g_ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(v, v_ref, rtol=5e-3, atol=0)
    np.testing.assert_allclose(g, g_ref, rtol=5e-3, atol=2e-2)


def test_tf32_round_is_round_to_nearest_ties_away():
    one, ulp = np.float32(1.0), np.float32(2.0 ** -10)  # TF32 spacing in [1, 2)
    a = torch.tensor([1.0, 1.0 + 0.49 * ulp, 1.0 + 0.5 * ulp, 1.0 + 0.51 * ulp,
                      -(1.0 + 0.5 * ulp), 3.0e-5, -7.25], dtype=torch.float32)
    r = logreg.tf32_round(a)
    assert r[:5].tolist() == [1.0, 1.0, float(one + ulp), float(one + ulp), -float(one + ulp)]
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - a).abs() <= a.abs() * 2.0 ** -11).all())
    t = logreg.tf32_truncate(a)
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all()) and bool((t.abs() <= a.abs()).all())


@pytest.mark.parametrize("shape", [(300, 7), (1024, 100), (1000, 100), (33, 128), (1, 1)])
def test_prepare_x_round_trips_exactly(shape):
    """Padding, the hi/lo split, the row permutation and the transposed copy
    of the tile images undo to X exactly, as hi + lo, from both copies; the
    padding is zeros and hi is TF32."""
    N, D = shape
    X = torch.from_numpy(np.random.default_rng(N + D).standard_normal((N, D)).astype(np.float32))
    prep = logreg.prepare_x(X, torch.zeros(N))
    DP, T = logreg.padded_dim(D), -(-N // logreg.TILE_N)
    assert DP % 8 == 0 and DP >= D
    assert prep.image.shape == (T, 4 * DP * logreg.TILE_N) and prep.image.is_contiguous()
    assert (prep.n_data, prep.dim, prep.dim_padded) == (N, D, DP)
    from_rows, from_cols = prep.unpack()
    assert torch.equal(from_rows, X) and torch.equal(from_cols, X)
    sections = prep.image.view(T, 4, -1)
    hi = sections[:, (0, 2)]
    assert bool(((hi.contiguous().view(torch.int32) & 0x1FFF) == 0).all())
    # what is not X is zero: both copies hold X's sum and nothing else
    total = X.double().sum()
    for pair in ((0, 1), (2, 3)):
        assert abs(float(sections[:, pair].double().sum() - total)) <= 1e-9 * max(1.0, abs(float(total)))
    assert int((sections[:, 0] != 0).sum()) <= N * D


def test_prepared_x_row_order_feeds_the_second_product():
    """Position k' of an 8-row block holds data row 2(k' % 4) + k' // 4: the
    rows the first product leaves with the thread that supplies k = (q, q+4)."""
    X = torch.arange(32 * 8, dtype=torch.float32).reshape(32, 8)  # exact in TF32
    prep = logreg.prepare_x(X, torch.zeros(32))
    DP = prep.dim_padded
    xt = prep.image.view(1, 4, -1)[0, 2].view(logreg.TILE_N // 4, DP // 8, 8, 4)  # (n'//4, d//8, d%8, n'%4)
    for n_pos in range(32):
        n = 8 * (n_pos // 8) + 2 * (n_pos % 4) + (n_pos % 8) // 4
        assert float(xt[n_pos // 4, 0, 3, n_pos % 4]) == float(X[n, 3])


def test_cuda_checks_refuse_what_the_tensor_core_kernel_does_not_take():
    P, X, v = torch.zeros(2, 3), torch.zeros(4, 3), torch.zeros(3)
    cuda_only = "expected the CUDA device"
    with pytest.raises(ValueError, match=cuda_only):  # device is checked first
        logreg._check(P, X, v, passes=2)
    meta = [t.to("meta") for t in (P, X, v)]
    with pytest.raises(ValueError, match=cuda_only):
        logreg._check(*meta)

    class OnCuda:  # stands in for CUDA tensors: only what _check reads
        def __init__(self, t):
            self.t, self.shape, self.dtype = t, t.shape, t.dtype
            self.device = torch.device("cuda", 0)

        def dim(self):
            return self.t.dim()

        def is_contiguous(self):
            return self.t.is_contiguous()

    on = [OnCuda(t) for t in (P, X, v)]
    with pytest.raises(ValueError, match="passes=3"):
        logreg._check(*on, passes=2)
    with pytest.raises(ValueError, match=r"prepare_x\(X, y\)"):  # the kernel has no other form
        logreg._check(*on)
    with pytest.raises(ValueError, match="prepared X is 5 x 3"):
        logreg._check(*on, prepared=logreg.prepare_x(torch.zeros(5, 3), torch.zeros(5)))
    with pytest.raises(ValueError, match="prepared X is on cpu"):
        logreg._check(*on, prepared=logreg.prepare_x(X, torch.zeros(4)))
    with pytest.raises(ValueError, match=r"expected \(4,\)"):
        logreg.prepare_x(X, torch.zeros(5))
    with pytest.raises(TypeError, match="float32"):
        logreg._check(OnCuda(P.double()), on[1], on[2])
    with pytest.raises(ValueError, match="not contiguous"):
        logreg._check(OnCuda(torch.zeros(3, 2).T), on[1], on[2])


def test_target_prepares_x_only_for_the_card():
    """On the CPU the target calls the plain version and builds no images."""
    from klara_tpu_torch.models import examples

    calls = []
    orig = examples.prepare_x
    examples.prepare_x = lambda X, y: calls.append(1) or orig(X, y)
    try:
        P, X, y, lam = _problem()
        t = examples.logistic_regression_target(X, y, lam, device="cpu")
        v, g = t.logdensity_and_grad(torch.from_numpy(P))
    finally:
        examples.prepare_x = orig
    assert calls == []
    rv, rg = _port(P, X, y, lam)
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(g.numpy(), rg)


def test_row_by_row_loglik_keeps_its_digits_where_the_model_fits():
    """At positions that fit the data the logits are large: p·v and the
    softplus sum are two sums of size ~|z|·N that nearly cancel, and their
    f32 rounding stays in the value.  Summed row by row, y z − softplus(z) is
    small for every fitted row (max(z, 0) − y z is exact for labels 0 and 1):
    the kernel's form is several times closer to float64 than the
    plain f32 version."""
    rng = np.random.default_rng(5)
    N, D, C = 512, 40, 64
    X = rng.standard_normal((N, D)).astype(np.float32)
    w = 2.0 * rng.standard_normal(D)
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-X @ w))).astype(np.float32)
    P = (w + 0.05 * rng.standard_normal((C, D))).astype(np.float32)
    v_ref, _ = _f64_oracle(P, X, y, 100.0)
    plain, _ = _port(P, X, y, 100.0)
    split, _ = _split(P, X, y, 100.0, passes=3)
    assert np.abs(split - v_ref).max() < 0.25 * np.abs(plain - v_ref).max()
    np.testing.assert_allclose(split, v_ref, rtol=2e-6, atol=1e-4)


def test_prepare_x_pads_the_labels():
    X = torch.ones(33, 3)
    y = torch.arange(33, dtype=torch.float32)
    prep = logreg.prepare_x(X, y)
    assert prep.y.shape == (64,) and torch.equal(prep.y[:33], y) and not prep.y[33:].any()
    assert prep.y.dtype == X.dtype and prep.y.is_contiguous()


@pytest.mark.parametrize("D", [129, 200])
def test_wide_form_arithmetic_matches_the_oracle(D):
    """Wider than K1's 128-column tile the card runs K1's wide form: f32
    products on the FP32 cores, the log-likelihood summed row by row.  Its
    arithmetic in plain PyTorch (``logreg_value_grad_split``) against the
    JAX autodiff oracle, with the tolerances of
    ``test_plain_matches_xla_batched`` (f32 both sides, another reduction
    order), and against float64 as f32-grade (rtol 2e-6, atol 1e-4, as
    ``test_three_pass_split_is_f32_grade``)."""
    P, X, y, lam = _problem(C=6, D=D, N=64, seed=D)
    v, g = _split(P, X, y, lam, passes=3)
    rv, rg = _oracle(P, X, y, lam)
    np.testing.assert_allclose(v, rv, rtol=1e-5)
    np.testing.assert_allclose(g, rg, atol=1e-4)
    fv, fg = _f64_oracle(P, X, y, lam)
    np.testing.assert_allclose(v, fv, rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(g, fg, rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize("D", [129, 200])
def test_prepare_x_for_the_wide_form(D):
    """What the card's path makes of a wide X: ``prepare_x`` keeps X as it
    is (the wide form reads it in place), pads the labels to whole tiles of
    32 rows and counts the 128-column tiles; the wrapper's checks take it."""
    P, X, y, _ = _problem(C=6, D=D, N=70, seed=D)
    Xt = torch.from_numpy(X)
    prep = logreg.prepare_x(Xt, torch.from_numpy(y))
    assert prep.wide and prep.dim_padded == 256 and (prep.n_data, prep.dim) == (70, D)
    assert torch.equal(prep.image, Xt) and prep.image.is_contiguous()
    assert prep.y.shape == (96,) and torch.equal(prep.y[:70], torch.from_numpy(y))
    assert not prep.y[70:].any()
    rows, cols = prep.unpack()
    assert torch.equal(rows, Xt) and torch.equal(cols, Xt)

    class OnCuda:  # stands in for CUDA tensors: only what _check reads
        def __init__(self, t):
            self.t, self.shape, self.dtype = t, t.shape, t.dtype
            self.device = torch.device("cuda", 0)

        def dim(self):
            return self.t.dim()

        def is_contiguous(self):
            return self.t.is_contiguous()

    prep = dataclasses.replace(prep, image=OnCuda(prep.image))
    logreg._check(OnCuda(torch.from_numpy(P)), OnCuda(Xt), OnCuda(torch.zeros(D)), 3, prep)
    logreg._check(OnCuda(torch.from_numpy(P)), OnCuda(Xt), OnCuda(torch.zeros(D)), 1, prep)
