"""Vectorized PCG32 (XSH-RR), bit-exact against the reference's host RNG
(a copy of niagara_tpu/utils/pcg.py's sequence functions).

The LCG state recurrence is affine, state_i = a^i * s0 + c * (a^(i-1) +
... + 1), so n outputs vectorize as a cumulative product/sum in wrapping
uint64 arithmetic.
"""

from __future__ import annotations

import numpy as np

PCG_MULT = np.uint64(6364136223846793005)
PCG_DEFAULT_INC = np.uint64(0xDA3E39CB94B95BDB)
PCG_DEFAULT_STATE = np.uint64(0x853C49E6748FEA9B)


def pcg32_sequence(n: int, state: int = int(PCG_DEFAULT_STATE), inc: int = int(PCG_DEFAULT_INC)) -> np.ndarray:
    """First n outputs of pcg32_random_r as uint32, starting from `state`."""
    a = PCG_MULT
    c = np.uint64(inc) | np.uint64(1)
    s0 = np.uint64(state)

    with np.errstate(over="ignore"):
        # A[i] = a^i (A[0] = 1); C[i] = c * (A[0] + ... + A[i-1]), C[0] = 0
        A = np.ones(n, dtype=np.uint64)
        if n > 1:
            A[1:] = a
            A = np.cumprod(A)
        C = np.zeros(n, dtype=np.uint64)
        if n > 1:
            C[1:] = np.cumsum(A[:-1]) * c
        old = A * s0 + C

        xorshifted = (((old >> np.uint64(18)) ^ old) >> np.uint64(27)).astype(np.uint32)
        rot = (old >> np.uint64(59)).astype(np.uint32)
        return (xorshifted >> rot) | (xorshifted << ((np.uint32(32) - rot) & np.uint32(31)))


def rand01_from_bits(bits: np.ndarray) -> np.ndarray:
    """uint32 -> double in [0,1), the reference's rand01 (division by 2^32)."""
    return bits.astype(np.float64) / float(1 << 32)
