"""Site-addressable, seed-deterministic fault injection — the port's copy
of ``trino_tpu/fault.py`` (which imports no JAX), kept here because the
port imports nothing of the JAX package.

The mesh executor's stage retries consult it (``exec/failure.py`` is a
stage-tag adapter over it, and ``exec/mesh.py`` checks the process-wide
injector at the ``task-exec`` site too). Schedules: ``arm`` (attempts
0..times-1 fail, the classic retry shape), ``arm_nth`` (exactly the n-th
matching call fails) and ``arm_probability`` (a seed-deterministic coin
per (seed, site, tag, attempt)). When nothing is armed every hook is a
None-check: no lock, no log.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass

__all__ = [
    "InjectedFault", "FaultInjector", "SITES",
    "activate", "deactivate", "active", "check",
]

#: the closed set of injection sites (typo'd arms fail fast)
SITES = frozenset(
    ["rpc", "spool-write", "spool-read", "task-exec", "device-oom",
     "planner", "compile-deserialize", "scan-read", "exchange-fetch",
     "heartbeat-loss", "announce-drop", "journal-write", "journal-read",
     "compile-delay"]
)


class InjectedFault(RuntimeError):
    """A chaos-armed failure. Carries its site/tag coordinates so
    recovery tiers can classify it (always retryable — an injected
    fault models a transient, not a semantic error)."""

    def __init__(self, site: str, tag: str, attempt: int, kind: str):
        self.site = site
        self.tag = tag
        self.attempt = attempt
        self.kind = kind
        super().__init__(
            f"injected fault: site={site} tag={tag!r} "
            f"attempt={attempt} kind={kind}"
        )


@dataclass
class _Rule:
    site: str
    tag: str  # prefix match against the call-site tag ("" = any)
    kind: str  # "times" | "nth" | "prob"
    times: int = 1  # kind=times: attempts 0..times-1 fail
    nth: int = 1  # kind=nth: the nth matching call fails (1-based)
    p: float = 0.0  # kind=prob: per-operation failure probability
    calls: int = 0  # matching-call counter (kind=nth bookkeeping)

    def spec(self) -> dict:
        return {
            "site": self.site, "tag": self.tag, "kind": self.kind,
            "times": self.times, "nth": self.nth, "p": self.p,
        }


def _coin(seed: int, site: str, tag: str, attempt: int) -> float:
    """Deterministic uniform [0,1) for one logical operation. Hashing
    (seed, site, tag, attempt) — never a call counter — means reruns
    and repeated polls of the same operation get the same verdict.
    blake2b (not crc32, whose linearity correlates nearby attempts;
    not ``hash()``, which varies per process) keeps the schedule
    well-mixed AND identical across processes and runs."""
    digest = hashlib.blake2b(
        f"{seed}|{site}|{tag}|{attempt}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2**64


class FaultInjector:
    """Seeded multi-site injector. Thread-safe; cheap when unarmed."""

    #: exception type raised on a fired rule — adapters (the mesh's
    #: legacy FailureInjector) narrow this to their own subtype
    fault_cls = InjectedFault

    def __init__(self, seed: int = 0, max_attempts: int = 4):
        self.seed = int(seed)
        self.max_attempts = max_attempts
        self._rules: list[_Rule] = []
        self._lock = threading.Lock()
        #: every armed-injector check: (site, tag, attempt, fired_kind
        #: or None). Byte-for-byte reproducible for a fixed seed and
        #: call sequence — the chaos determinism tests diff this.
        self.decisions: list[tuple[str, str, int, str | None]] = []
        #: (tag, attempt) of faults actually raised (site recorded in
        #: ``decisions``; tag-only keeps the legacy adapter log shape)
        self.injected: list[tuple[str, int]] = []
        #: attempt used by module-level hooks that have no attempt of
        #: their own (worker sets this to the task attempt in flight)
        self.default_attempt = 0

    # ---- arming ----------------------------------------------------
    def _arm(self, rule: _Rule):
        if rule.site not in SITES:
            raise ValueError(
                f"unknown fault site {rule.site!r} "
                f"(expected one of {sorted(SITES)})"
            )
        with self._lock:
            self._rules.append(rule)

    def arm(self, site: str, tag: str = "", times: int = 1):
        """Fail attempts 0..times-1 of operations matching site+tag
        (the retry-shape schedule: attempt ``times`` succeeds)."""
        self._arm(_Rule(site=site, tag=tag, kind="times", times=times))

    def arm_nth(self, site: str, n: int, tag: str = ""):
        """Fail exactly the n-th matching call (1-based)."""
        if n < 1:
            raise ValueError(f"arm_nth n must be >= 1, got {n}")
        self._arm(_Rule(site=site, tag=tag, kind="nth", nth=n))

    def arm_probability(self, site: str, p: float, tag: str = ""):
        """Fail each logical operation with probability ``p``, decided
        by a deterministic hash of (seed, site, tag, attempt)."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"probability must be in [0,1], got {p}")
        self._arm(_Rule(site=site, tag=tag, kind="prob", p=p))

    def reset(self):
        with self._lock:
            self._rules.clear()
            self.decisions.clear()
            self.injected.clear()

    @property
    def armed(self) -> bool:
        return bool(self._rules)

    # ---- checking --------------------------------------------------
    def check(self, site: str, tag: str = "", attempt: int | None = None):
        """Raise InjectedFault if a rule fires for this operation.
        No-op (no lock, no log) when nothing is armed."""
        if not self._rules:
            return
        if attempt is None:
            attempt = self.default_attempt
        with self._lock:
            fired = None
            for rule in self._rules:
                if rule.site != site or not tag.startswith(rule.tag):
                    continue
                rule.calls += 1
                if rule.kind == "times":
                    if attempt < rule.times:
                        fired = rule
                        break
                elif rule.kind == "nth":
                    if rule.calls == rule.nth:
                        fired = rule
                        break
                elif rule.kind == "prob":
                    if _coin(self.seed, site, tag, attempt) < rule.p:
                        fired = rule
                        break
            self.decisions.append(
                (site, tag, attempt, fired.kind if fired else None)
            )
            if fired is not None:
                self.injected.append((tag, attempt))
                raise self.fault_cls(site, tag, attempt, fired.kind)

    # ---- cross-process shipping ------------------------------------
    def to_spec(self) -> dict:
        """JSON-serializable description (rules + seed), suitable for
        riding a stage-task request into a worker process."""
        with self._lock:
            return {
                "seed": self.seed,
                "max_attempts": self.max_attempts,
                "rules": [r.spec() for r in self._rules],
            }

    @classmethod
    def from_spec(cls, spec: dict, default_attempt: int = 0
                  ) -> "FaultInjector":
        inj = cls(seed=spec.get("seed", 0),
                  max_attempts=spec.get("max_attempts", 4))
        inj.default_attempt = default_attempt
        for r in spec.get("rules", []):
            inj._arm(_Rule(
                site=r["site"], tag=r.get("tag", ""),
                kind=r.get("kind", "times"), times=r.get("times", 1),
                nth=r.get("nth", 1), p=r.get("p", 0.0),
            ))
        return inj


# ---- process-global active injector -------------------------------
#
# Layers that have no injector plumbed through their signatures
# (spool, memory) consult the process-global active injector. The
# worker installs one per stage task (serialized under the runner
# lock); tests install one around a block via ``activate``.

_active: FaultInjector | None = None


def activate(inj: FaultInjector | None):
    global _active
    _active = inj


def deactivate():
    global _active
    _active = None


def active() -> FaultInjector | None:
    return _active


def check(site: str, tag: str = "", attempt: int | None = None):
    """Module-level hook: no-op unless an injector is active."""
    inj = _active
    if inj is not None:
        inj.check(site, tag, attempt)
