"""Typed render configuration.

Replaces the reference's two-tier config (compile-time ``#define``s +
six hand-rolled CLI flags; SURVEY.md §5 "Config / flag system") with one
dataclass driving both the CLI and the library API.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class RenderConfig:
    # workload (reference defaults: main_cli.cpp:46-47, main_cli.cpp:18-20)
    width: int = 200
    height: int = 200
    spp: int = 8
    spl: int = 8
    eye_depth: int = 4          # EYE_DEPTH
    light_depth: int = 4        # LIGHT_DEPTH
    # bounded-scan budget for delta bounces: the reference's `depth--` retry
    # makes path length unbounded between mirrors (quirk 11); we budget
    # extra scan iterations instead.  max iterations = depth + delta_budget.
    delta_budget: int = 8

    # integrator constants
    clamp: float = 15.0         # firefly clamp (pt_cu.cu:100 etc.)
    ppm_radius: float = 0.05    # PPM_RADIUS (ppm_cu.cuh:5)
    ppm_hash_size: int = 1000003  # HASH_TABLE_SIZE (ppm_cu.cuh:6)
    ppm_max_per_cell: int = 64  # static gather budget per grid cell
    # 0 = exact gather (up to ppm_max_per_cell); N > 0 = unbiased stratified
    # subsampling of N events per cell, contributions scaled by count/N —
    # same expectation, bounded work in photon-dense cells
    ppm_cell_samples: int = 0
    # 0 = connect every eye vertex to EVERY light vertex (reference
    # semantics, bdpt_cu.cu:384); N > 0 = unbiased stratified subsample of N
    # light vertices per eye vertex, scaled by n_valid/N — same expectation,
    # O(N) instead of O(V) per connection
    bdpt_connection_samples: int = 0
    # 0 = keep the full compacted light-vertex table; K > 0 = importance-cull
    # it to K rows by contribution-proportional resampling (RIS weights baked
    # into the resampled throughputs — unbiased; integrators/bdpt.py::
    # resample_light_vertices).  The O(V)-per-eye-vertex sweep becomes O(K);
    # worth it once V >> K (large spl / deep light paths)
    bdpt_resample_vertices: int = 0
    # 0 = fixed-radius PPM (the reference never shrinks, quirk 13);
    # alpha in (0,1) = progressive radius: r_i^2 = r^2 * prod (i+alpha)/(i+1)
    # (Hachisuka-style), pass index supplied by the caller
    ppm_alpha: float = 0.0

    # determinism
    seed: int = 0

    # parity switches
    # True  -> reproduce the reference PT's stubbed MIS "strategy A"
    #          (BSDF ray hitting a light from a non-delta vertex contributes
    #          nothing, pt_cu.cu:104-119, quirk 2)
    # False -> the fixed, full-MIS estimator
    pt_stub_mis_strategy_a: bool = True
    # GPU shadow rays block on any occluder (quirk 12); the CPU oracle lets
    # dielectrics pass (cpu_bdpt.cpp:102).
    shadow_dielectrics_block: bool = True
    # front-ends force fov=50 (quirk 7); None honors the scene file.
    force_fov: float | None = None

    @property
    def max_eye_iters(self) -> int:
        return self.eye_depth + self.delta_budget

    @property
    def max_light_iters(self) -> int:
        return self.light_depth + self.delta_budget

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)


def oracle_config(cfg: RenderConfig) -> RenderConfig:
    """CPU-BDPT-oracle parity flags (cpu_bdpt.cpp semantics)."""
    return cfg.with_(shadow_dielectrics_block=False)
