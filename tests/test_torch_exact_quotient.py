"""The divide that csrc/svj_stats.cu:quot makes for the corridor's nine
quotients an increment: q = a r, e = fma(-s, q, a), q + e r with r the
correctly rounded 1 / s (Markstein). It must give the correctly rounded
a / s, the bits of the library's __fdiv_rn, wherever the kernel takes it
(|a| below 2^26 and s in [1e-20, 1e30), so that nothing over- or
underflows). Here every step of the sequence is rounded to float32 from
the exact rational value, as the card's FMUL and FFMA round, and the
result is held against the exactly rounded quotient. Needs no card."""

import random
from fractions import Fraction

import numpy as np
import pytest

_F32 = np.float32


def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    c = _F32(float(x))
    best = None
    for cand in (np.nextafter(c, _F32(-np.inf)), c,
                 np.nextafter(c, _F32(np.inf))):
        dist = abs(Fraction(float(cand)) - x)
        odd = int(np.frombuffer(cand.tobytes(), np.uint32)[0]) & 1
        if best is None or (dist, odd) < best[0]:
            best = ((dist, odd), cand)
    return best[1]


def _quot(a: np.float32, s: np.float32) -> np.float32:
    fa, fs = Fraction(float(a)), Fraction(float(s))
    r = _rn32(1 / fs)
    q = _rn32(fa * Fraction(float(r)))
    e = _rn32(fa - fs * Fraction(float(q)))                  # fma(-s, q, a)
    return _rn32(Fraction(float(e)) * Fraction(float(r))
                 + Fraction(float(q)))                       # fma(e, r, q)


def _bits(m: int, e: int, sign: int = 0) -> np.float32:
    return np.frombuffer(np.uint32((sign << 31) | ((e + 127) << 23) | m)
                         .tobytes(), np.float32)[0]


@pytest.mark.parametrize("seed", range(4))
def test_shared_reciprocal_quotient_is_correctly_rounded(seed):
    rng = random.Random(seed)
    pairs = []
    for _ in range(600):    # the corridor's numerators and step variances
        pairs.append((_F32((rng.random() * 2 - 1)
                           * 10 ** rng.uniform(-12, 7.8)),
                      _F32(10 ** rng.uniform(-20, 29.9))))
    for _ in range(400):    # mantissas at the edges: all ones, one, half
        mb = rng.choice([0x7FFFFF, 0x7FFFFE, 0x000001, 0x400000,
                         rng.getrandbits(23)])
        ma = rng.choice([0x7FFFFF, 0x000000, rng.getrandbits(23)])
        pairs.append((_bits(ma, rng.randint(-60, 25), rng.getrandbits(1)),
                      _bits(mb, rng.randint(-66, 30))))
    for a, s in pairs:
        want = _rn32(Fraction(float(a)) / Fraction(float(s)))
        assert _quot(a, s) == want, (a, s)
