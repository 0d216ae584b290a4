"""Recovery for long progressive renders.

The reference has no failure handling at all — a CUDA fault mid-render
loses the whole accumulation (``src/main.cpp`` render loop just dies).
:class:`RenderSupervisor` drives a per-iteration render callable with
bounded retries.  On an exception it snapshots the accumulated state via
the caller's checkpoint hook (progress is never lost), clears jax's
trace/compile caches, and re-runs the same iteration.  Failures are counted
per *iteration*, so one flaky pass cannot burn the whole budget.

The CLI wires this behind ``--retries`` (default 1 retry).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable


class StopRender(BaseException):
    """Graceful early-stop request from inside ``on_frame`` (e.g. the
    CLI's SIGUSR2 handler).  Derives from BaseException so the
    supervisor's device-fault retry loop (``except Exception``) passes it
    through instead of re-running the iteration."""


@dataclass
class RenderSupervisor:
    """Retrying driver for a progressive render loop.

    ``run(frame, start, iters, on_frame)`` calls ``frame(i)`` for each
    iteration, passing the realized result to ``on_frame(i, value)`` (the
    accumulation step).  If ``frame`` or ``on_frame`` raises, the
    supervisor calls ``checkpoint()`` (if given), ``jax.clear_caches()``,
    waits ``backoff_s`` and retries the same iteration up to
    ``max_retries`` times before re-raising the last error.
    """

    max_retries: int = 1
    backoff_s: float = 2.0
    checkpoint: Callable[[], None] | None = None
    log: Callable[[str], None] = print
    failures: int = field(default=0, init=False)

    def run(self, frame: Callable[[int], Any], start: int, iters: int,
            on_frame: Callable[[int, Any], None]) -> None:
        for i in range(start, start + iters):
            attempts = 0
            while True:
                try:
                    on_frame(i, frame(i))
                    break
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # noqa: BLE001 — any device fault
                    self.failures += 1
                    attempts += 1
                    self._salvage(i, e)
                    if attempts > self.max_retries:
                        raise
                    time.sleep(self.backoff_s)

    def _salvage(self, i: int, err: Exception) -> None:
        self.log(f"[Recover] iter {i + 1} failed: {type(err).__name__}: "
                 f"{err}")
        if self.checkpoint is not None:
            try:
                self.checkpoint()
                self.log("[Recover] accumulation checkpointed")
            except Exception as ce:  # noqa: BLE001
                self.log(f"[Recover] checkpoint also failed: {ce}")
        try:
            import jax

            jax.clear_caches()
        except Exception:  # noqa: BLE001 — clearing caches is best-effort
            pass
