"""A frozen Philox4x32-10 and the keyed-draw transforms the port's streams use.

Plain torch on int64 tensors, any device.  A run key is one int64 drawn
from a ``torch.Generator`` (``run_key``); a draw's counter is four 32-bit
words: (the chain's global index, the step, site << 8 | part,
element << 12 | call).  A sampler's site is the window's top, ``MH_SITE``,
less the draw's offset.  Salmon, Moraes, Dror & Shaw, "Parallel random
numbers: as easy as 1, 2, 3" (SC'11), with the Random123 constants.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MH_SITE = (1 << 24) - 1
# a sampler's draw offsets below its window's top
MOMENTUM, ACCEPT, INIT_MOMENTUM, SHARED_JITTER = 1, 2, 10, 12
CALL_BITS = 12
MAX_ATTEMPTS = 64


def run_key(generator, device) -> int:
    """The run key a job draws from ``generator``: one int64, as an int."""
    return int(torch.randint(-2**63, 2**63 - 1, (), dtype=torch.int64, generator=generator,
                             device=device))


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of the constant ``a`` times the int64 words ``b``,
    exact without overflow: 16-bit halves."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = ah * bl + al * bh
    lo_full = al * bl + ((mid & 0xFFFF) << 16)
    lo = lo_full & MASK
    hi = (ah * bh + (mid >> 16) + (lo_full >> 32)) & MASK
    return hi, lo


def philox(c0, c1, c2, c3, key: int):
    """Philox4x32-10 of int64 counter words (broadcast together) under the
    int64 run ``key``: four int64 tensors of 32-bit words."""
    device = next((c.device for c in (c0, c1, c2, c3) if torch.is_tensor(c)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(*(torch.as_tensor(c, dtype=torch.int64,
                                                               device=device)
                                               for c in (c0, c1, c2, c3)))
    k0, k1 = key & MASK, (key >> 32) & MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def words(key: int, chains, step, site: int, elements, call: int = 0, part: int = 0):
    """The words of the draws of ``chains`` (int64, any shape) at ``step``
    (an int or int64 tensor), ``site`` and ``elements`` (int64, broadcast
    against them) for one Philox ``call``."""
    device = next((c.device for c in (chains, step, elements) if torch.is_tensor(c)), None)
    step = torch.as_tensor(step, dtype=torch.int64, device=device) & MASK
    elements = torch.as_tensor(elements, dtype=torch.int64, device=device)
    return philox(chains, step, (site << 8) | part, (elements << CALL_BITS) | call, key)


def u01(w, dtype=torch.float64):
    """U(0, 1) from the top 24 bits of a word (the f32 uniform, exact in f64)."""
    return ((w >> 8).to(dtype) * 2.0**-24).clamp_min(2.0**-25)


def normal(w0, w1, dtype=torch.float64):
    """Box-Muller's cosine branch from a call's first two words."""
    u1, u2 = u01(w0, dtype), u01(w1, dtype)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(u2 * (2.0 * math.pi))


def standard_gamma(key: int, chains, step, site: int, alpha: float, tol: float,
                   dtype=torch.float64):
    """Marsaglia & Tsang's standard gamma(``alpha`` ≥ 1) of one element a
    chain, attempt t from call 1 + t (x from words 0-1, u from word 2), in
    ``dtype``.  Returns (values, ambiguous): ``ambiguous`` marks the draws
    whose accept test at some attempt came within ``tol`` of its boundary,
    where rounding in another precision may decide the other way."""
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    device = next((t.device for t in (chains, step) if torch.is_tensor(t)), None)
    chains, step = torch.broadcast_tensors(torch.as_tensor(chains, device=device),
                                           torch.as_tensor(step, device=device))
    out = torch.full(chains.shape, math.nan, dtype=dtype, device=chains.device)
    ambiguous = torch.zeros(chains.shape, dtype=torch.bool, device=chains.device)
    todo = torch.ones(chains.shape, dtype=torch.bool, device=chains.device)
    for t in range(MAX_ATTEMPTS):
        if not bool(todo.any()):
            break
        w = words(key, chains[todo], step[todo], site, 0, call=1 + t)
        x = normal(w[0], w[1], dtype)
        u = u01(w[2], dtype)
        y = 1.0 + c * x
        v = y * y * y
        xx = x * x
        m1 = (1.0 - 0.0331 * xx * xx) - u
        m2 = (0.5 * xx + d * (1.0 - v + torch.log(torch.clamp_min(v, 1e-30)))) - torch.log(u)
        ok = (y > 0) & ((m1 > 0) | (m2 > 0))
        near = (y > 0) & ~((m1 > tol) | (m2 > tol)) & ~((m1 < -tol) & (m2 < -tol))
        idx = todo.nonzero(as_tuple=True)
        ambiguous[idx] |= near
        val = out[idx]
        out[idx] = torch.where(ok, d * v, val)
        done = todo.clone()
        done[idx] = ok
        todo &= ~done
    return out, ambiguous
