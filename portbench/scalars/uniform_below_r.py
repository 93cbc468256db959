"""Scalars uniform in [0, 0x73ED * 2^240), a range that holds all but
0.0022 % of [0, r): the coefficients of a batch verifier's random linear
combination, which make every merged scalar uniform.

A sampler is found by the name a traffic file gives under `scalars`; it has
`draw(gen, n, device, **params)`, which returns (16, n) int32 canonical limbs
of n values below r, drawn from the CUDA (or CPU) generator `gen`.
"""
import torch

LIMBS = 16
R_TOP_LIMB = 0x73ED  # the top 16-bit limb of r: a top limb below it keeps a value below r


def draw(gen: torch.Generator, n: int, device) -> torch.Tensor:
    s = torch.randint(0, 1 << 16, (LIMBS, n), generator=gen, device=device, dtype=torch.int32)
    s[LIMBS - 1] = torch.randint(0, R_TOP_LIMB, (n,), generator=gen, device=device, dtype=torch.int32)
    return s
