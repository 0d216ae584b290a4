"""path_tracing_tpu — a physically-based rendering framework in JAX.

A from-scratch JAX / XLA re-architecture with the capabilities of
the reference CUDA renderer (HongMJ1315/Path_Tracing): three global-
illumination integrators (unidirectional PT with NEE+MIS, bidirectional PT
with balance-heuristic MIS, progressive photon mapping), the same text scene
format, a CLI, progressive accumulation with convergence telemetry, a
deterministic CPU BDPT oracle, and PNG output — built as batched fixed-shape
array programs (bounded masked bounce scans, counter-based RNG, sort/scatter
photon binning, `shard_map` multi-device sharding) rather than megakernel
translations.
"""

__version__ = "0.1.0"

from .config import RenderConfig  # noqa: F401
