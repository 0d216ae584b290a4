"""Recovery (runtime/resilience.py).

The reference has no failure handling: a CUDA fault mid-render loses the
whole accumulation.  These tests pin the replacement — a retrying render
supervisor that checkpoints before retrying and never drops completed
iterations.
"""
import jax.numpy as jnp
import pytest

from path_tracing_tpu.runtime.resilience import RenderSupervisor


def test_supervisor_retries_transient_fault():
    calls = {"n": 0}
    acc = []

    def frame(i):
        calls["n"] += 1
        if i == 1 and calls["n"] == 2:  # iteration 1 fails once
            raise RuntimeError("transient FAILED_PRECONDITION")
        return jnp.float32(i)

    ckpts = []
    sup = RenderSupervisor(max_retries=1, backoff_s=0.0,
                           checkpoint=lambda: ckpts.append(len(acc)),
                           log=lambda m: None)
    sup.run(frame, 0, 3, lambda i, v: acc.append((i, float(v))))

    # every iteration landed exactly once, in order, despite the fault
    assert acc == [(0, 0.0), (1, 1.0), (2, 2.0)]
    assert sup.failures == 1
    # the salvage checkpoint ran at the failure point (1 iter accumulated)
    assert ckpts == [1]


def test_supervisor_exhausts_retries_and_raises():
    def frame(i):
        raise RuntimeError("hard fault")

    ckpts = []
    sup = RenderSupervisor(max_retries=2, backoff_s=0.0,
                           checkpoint=lambda: ckpts.append(1),
                           log=lambda m: None)
    with pytest.raises(RuntimeError, match="hard fault"):
        sup.run(frame, 0, 1, lambda i, v: None)
    # initial attempt + 2 retries, each salvaged
    assert sup.failures == 3
    assert ckpts == [1, 1, 1]


def test_supervisor_zero_retries_fails_fast():
    sup = RenderSupervisor(max_retries=0, backoff_s=0.0, log=lambda m: None)
    with pytest.raises(ValueError):
        sup.run(lambda i: (_ for _ in ()).throw(ValueError("x")),
                0, 1, lambda i, v: None)
    assert sup.failures == 1


def test_supervisor_on_frame_fault_also_retried():
    # faults in the accumulation step (e.g. a host transfer dying) get the
    # same retry treatment as the render itself
    state = {"fail": True, "acc": 0.0}

    def on_frame(i, v):
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("transfer error")
        state["acc"] += float(v)

    sup = RenderSupervisor(max_retries=1, backoff_s=0.0, log=lambda m: None)
    sup.run(lambda i: jnp.float32(2.0), 0, 1, on_frame)
    assert state["acc"] == 2.0
