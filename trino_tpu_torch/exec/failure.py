"""Failure injection + stage retry of the mesh executor — the port's copy
of ``trino_tpu/exec/failure.py``.

The analog of the reference's FailureInjector + task-retry unit
(MAIN/execution/FailureInjector.java:39, injectTaskFailure:61; retry
semantics of EventDrivenFaultTolerantQueryScheduler,
MAIN/execution/scheduler/faulttolerant/): tests arm failures for a
stage tag and attempt range; the mesh executor consults the injector
before each stage-shard program and re-invokes the program on an
injected failure. The retry unit works because stage inputs are
retained device arrays — "spooled stage output" in the reference maps
to XLA buffers that outlive the failed invocation here.

Since the unified chaos framework landed this module is a thin
adapter over ``trino_tpu_torch.fault``: ``FailureInjector`` maps its stage
tags onto the ``task-exec`` site of a seeded ``FaultInjector`` (so a
chaos run can arm mesh-stage failures alongside spool/RPC faults from
one injector spec), while keeping the original two-argument
``check(tag, attempt)`` call shape and ``injected``/``attempts`` log
formats that the mesh executor and its tests were built against.
"""

from __future__ import annotations

from trino_tpu_torch.fault import FaultInjector, InjectedFault

__all__ = ["InjectedFailure", "FailureInjector"]


class InjectedFailure(InjectedFault):
    """A test-armed failure (InjectionType.TASK_FAILURE analog)."""


class FailureInjector(FaultInjector):
    """Stage-tag adapter over the unified injector: all rules live on
    the ``task-exec`` site, and ``check`` takes (tag, attempt)."""

    fault_cls = InjectedFailure
    SITE = "task-exec"

    def __init__(self, max_attempts: int = 4, seed: int = 0):
        super().__init__(seed=seed, max_attempts=max_attempts)
        #: log of (tag, attempt) stage executions that ran (armed runs
        #: only — the unarmed fast path keeps zero bookkeeping)
        self.attempts: list[tuple[str, int]] = []

    def fail_stage(self, tag: str, times: int = 1):
        """Arm ``times`` consecutive failures for stages whose tag
        starts with ``tag`` (attempts 0..times-1 fail; the retry at
        attempt ``times`` succeeds)."""
        self.arm(self.SITE, tag=tag, times=times)

    def reset(self):
        super().reset()
        self.attempts.clear()

    def check(self, tag: str = "", attempt: int = 0):  # noqa: D102
        if not self._rules:
            return  # production fast path: no bookkeeping, no lock
        self.attempts.append((tag, attempt))
        super().check(self.SITE, tag=tag, attempt=attempt)
