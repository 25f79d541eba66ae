"""The yardstick on the CPU: the reference imports nothing of the program,
the frozen Philox against Random123's known answers and the port's draws,
the frozen ESS and R̂ against hand cases, the work counts at the cells'
shapes."""

from __future__ import annotations

import json
import math
import subprocess
import sys

import pytest
import torch

from portbench import harness, stats, work
from portbench.reference import philox as P

YARDSTICK = ("portbench.reference.philox", "portbench.reference.logreg",
             "portbench.reference.rats", "portbench.stats", "portbench.work")


def test_the_yardstick_imports_nothing_of_the_program():
    script = (f"import json, sys\nfor m in {YARDSTICK!r}: __import__(m)\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"klara_tpu_torch", "klara_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    out = P.philox(*counter, key[0] | (key[1] << 32))
    assert tuple(int(w) for w in out) == want


def test_keyed_draws_match_the_port_on_the_cpu():
    """The frozen draws agree with the port's plain version at the sites the
    cells draw at (the uniforms exactly; normals and gammas to f32)."""
    from klara_tpu_torch.ops import keyed as K

    key = -(2**62) + 12345
    s = K.KeyedStream(torch.tensor(key), 8, 0, step=77)
    w = P.words(key, torch.arange(8)[:, None], 77, P.MH_SITE - P.MOMENTUM,
                torch.arange(5)[None, :])
    z = s.window_site(K.MOMENTUM).normal((8, 5)).double()
    assert torch.allclose(z, P.normal(w[0], w[1]), rtol=0, atol=1e-5)
    u = s.window_site(K.ACCEPT).uniform((8,)).double()
    assert torch.equal(u, P.u01(P.words(key, torch.arange(8), 77, P.MH_SITE - P.ACCEPT, 0)[0]))
    for site, alpha in ((4, 75.001), (5, 15.001)):
        g = s.at(site=site).standard_gamma(alpha, (8,)).double()
        gr, amb = P.standard_gamma(key, torch.arange(8), 77, site, alpha, 1e-4)
        assert torch.allclose(g[~amb], gr[~amb], rtol=1e-5)


def test_ess_of_independent_draws():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2000, 64, 3, generator=g)
    e = stats.ess(x)
    assert torch.all((e > 0.85 * 2000 * 64) & (e < 1.15 * 2000 * 64))


def test_ess_of_an_ar1_chain():
    """ESS of AR(1) with coefficient ρ: n(1 − ρ)/(1 + ρ) a chain."""
    rho, n, m = 0.8, 8000, 32
    g = torch.Generator().manual_seed(2)
    eps = torch.randn(n, m, generator=g)
    x = torch.empty(n, m)
    x[0] = eps[0] / math.sqrt(1 - rho * rho)
    for t in range(1, n):
        x[t] = rho * x[t - 1] + eps[t]
    want = n * m * (1 - rho) / (1 + rho)
    assert abs(float(stats.ess(x[..., None])[0]) / want - 1) < 0.1


def test_rank_rhat_gate():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1000, 16, 2, generator=g)
    assert stats.max_rhat(x) < stats.RHAT_GATE
    x[:, :8] += 0.5
    assert stats.max_rhat(x) > stats.RHAT_GATE


def test_min_ess_through_a_factor():
    """Scoring in x = y Lᵀ space: a scaled coordinate keeps its ESS."""
    g = torch.Generator().manual_seed(4)
    y = torch.randn(500, 200, 4, generator=g)
    L = torch.diag(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert math.isclose(stats.min_ess(y, L), stats.min_ess(y), rel_tol=1e-4)


def test_work_counts_at_the_cell_shapes():
    C, N, D = 16384, 1024, 100
    assert work.k1_flops(C, N, D) == 4 * C * N * D == 6_710_886_400
    assert math.isclose(work.k1_least_s(C, N, D), 6_710_886_400 / 495e12)
    assert math.isclose(work.k1_least_s(C, N, D) * 1e6, 13.557, rel_tol=1e-3)
    assert math.isclose(work.k1_bytes(C, N, D), 4 * (2 * C * D + N * D + N + C))
    assert work.whitened_eval_flops(C, N, D) == 4 * C * N * D + 4 * C * D * D
    # K1 is compute-bound at the cell's shape: the bytes take ~4 µs
    assert work.k1_bytes(C, N, D) / work.HBM_BYTES_PER_S < work.k1_flops(C, N, D) / 495e12


def test_bf16_spacing():
    from portbench.reference.logreg import bf16_ulp

    x = torch.tensor([1.0, 1.5, 2.0, 0.25], dtype=torch.float64)
    assert torch.equal(bf16_ulp(x), torch.tensor([2**-7, 2**-7, 2**-6, 2**-9],
                                                 dtype=torch.float64))
