"""Fault tolerance: heartbeats, restart policy, elastic re-mesh, stragglers
(the port's copy of :mod:`repro.runtime.fault_tolerance`, pure Python).

The resident study service (:mod:`repro_torch.serve`) drives these
primitives with one in-process worker:

* **Heartbeat monitor** — every host reports (step, timestamp); the
  coordinator marks hosts dead after ``timeout_s`` and triggers the restart
  policy.
* **Restart policy** — on failure, resume on the same mesh or re-mesh onto
  the surviving device count (e.g. 512 -> 256 by dropping the pod axis),
  or halt below ``min_devices``.
* **Elastic re-mesh** — :func:`degraded_mesh_shape` picks the mesh shape of
  the survivors, keeping the model axis whole.
* **Straggler mitigation** — per-step host latencies feed an EWMA; hosts
  slower than ``straggler_factor`` x median for ``patience`` consecutive
  steps are reported.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    _last: dict[int, float] = dataclasses.field(default_factory=dict)
    _step: dict[int, int] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, step: int, now: float | None = None):
        self._last[host] = time.monotonic() if now is None else now
        self._step[host] = step

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self._last.items() if now - t > self.timeout_s]

    def remove_host(self, host: int) -> None:
        """Forget a host entirely — the restart path MUST call this after it
        has handled a death (cordon + replace / re-mesh), or the monitor
        reports the dead host forever: ``dead_hosts()`` keeps flagging it on
        every check and ``min_step()`` keeps clamping global progress to its
        last step, so one transient death would poison every subsequent
        health check.  Unknown hosts are a no-op (a host may die before its
        first beat)."""
        self._last.pop(host, None)
        self._step.pop(host, None)

    def min_step(self) -> int:
        return min(self._step.values()) if self._step else 0


@dataclasses.dataclass
class StragglerDetector:
    straggler_factor: float = 1.5
    patience: int = 3
    ewma: float = 0.5
    _lat: dict[int, float] = dataclasses.field(default_factory=dict)
    _strikes: dict[int, int] = dataclasses.field(default_factory=lambda: defaultdict(int))

    def observe(self, host: int, latency_s: float):
        prev = self._lat.get(host, latency_s)
        self._lat[host] = self.ewma * latency_s + (1 - self.ewma) * prev

    def stragglers(self) -> list[int]:
        if len(self._lat) < 2:
            return []
        lats = sorted(self._lat.values())
        median = lats[len(lats) // 2]
        out = []
        for h, l in self._lat.items():
            if l > self.straggler_factor * median:
                self._strikes[h] += 1
                if self._strikes[h] >= self.patience:
                    out.append(h)
            else:
                self._strikes[h] = 0
        return out


def degraded_mesh_shape(n_devices: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Pick a mesh shape for the surviving device count (elastic re-mesh).

    Keeps the model axis at 16 whenever possible (TP groups must stay whole
    — a dead host kills its whole TP group) and shrinks data/pod.
    """
    model = 16 if n_devices % 16 == 0 else 1
    rest = n_devices // model
    if rest >= 32 and rest % 16 == 0:
        return (rest // 16, 16, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


@dataclasses.dataclass
class RestartPolicy:
    """Decide what to do after failures: resume (same mesh) or re-mesh."""

    total_devices: int
    min_devices: int

    def plan(self, dead_hosts: list[int], devices_per_host: int = 4) -> dict:
        lost = len(dead_hosts) * devices_per_host
        surviving = self.total_devices - lost
        if lost == 0:
            return {"action": "none"}
        if surviving < self.min_devices:
            return {"action": "halt", "surviving": surviving}
        shape, axes = degraded_mesh_shape(surviving)
        return {"action": "remesh", "surviving": surviving,
                "mesh_shape": shape, "mesh_axes": axes}
