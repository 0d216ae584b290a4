"""Agreement between two renders drawn with the same key.

Two renders of one estimator under one key draw the same random numbers,
whether they run on two backends or sharded against one device.  They agree
per pixel to float rounding, except where FMA contraction or another
summation order pushes a branch across a threshold: such a pixel "flips" and
differs by the whole contribution of the paths that took the other branch.
So agreement is judged on three numbers: the median per-pixel relative
error, the fraction of flipped pixels, and the total energy.  A spatial
permutation, a lost shard or a wrong estimator fails all three.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

REL_FLOOR = 1e-3   # added to |reference| in the relative-error denominator
FLIP_REL = 1e-3    # a pixel whose relative error exceeds this has flipped


@dataclass(frozen=True)
class Agreement:
    bit_exact: bool
    median_rel: float   # median over pixels and channels
    max_rel: float
    flipped: float      # fraction of pixels with any channel above FLIP_REL
    energy_rel: float   # |sum(x) - sum(ref)| / |sum(ref)|

    def ok(self, max_flipped: float, max_median_rel: float = 1e-5,
           max_energy_rel: float = 0.01) -> bool:
        return (self.bit_exact
                or (self.median_rel <= max_median_rel
                    and self.flipped <= max_flipped
                    and self.energy_rel <= max_energy_rel))

    def __str__(self) -> str:
        if self.bit_exact:
            return "bit-exact"
        return (f"median rel {self.median_rel:.3e}, max rel "
                f"{self.max_rel:.3e}, flipped {self.flipped:.4%}, "
                f"energy rel {self.energy_rel:.3e}")


def agreement(x, ref) -> Agreement:
    """Compare a render ``x`` against ``ref``: both (pixels, 3) arrays."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    if x.shape != ref.shape:
        raise ValueError(f"shape mismatch: {x.shape} vs {ref.shape}")
    rel = np.abs(x - ref) / (np.abs(ref) + REL_FLOOR)
    total = float(ref.sum())
    return Agreement(
        bit_exact=bool(np.array_equal(x, ref)),
        median_rel=float(np.median(rel)),
        max_rel=float(rel.max(initial=0.0)),
        flipped=float(np.mean(np.any(rel > FLIP_REL, axis=-1))),
        energy_rel=abs(float(x.sum()) - total) / max(abs(total), 1e-30),
    )
