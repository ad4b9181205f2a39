"""Adaptive coalescing policy: when to batch, how wide, and who to trust
(PyTorch port of :mod:`repro.serve.policy`, pure Python).

LazyPIM's thesis is that *judicious* speculation wins: batch coherence
work lazily, but commit/roll back at kernel granularity so over-eager
batching never pays more than it saves (the paper's partial-commit
cliff).  A greedy coalescer drains every compatible queued request into
the widest blessed dispatch, which is right at queue depth 16 and wrong
for a lone interactive request or a group key that fails its audit every
time.  This module is the judgement, three decisions wired through
:meth:`repro_torch.serve.server.StudyServer.step`:

* **Formation window** — under light load (a shallow but non-empty
  backlog) the head request *holds* for a short clock-driven window so
  compatible peers arriving between cooperative steps can share its
  dispatch — but only while every member's deadline slack affords both
  the hold and the EMA-predicted dispatch that follows.  A deep queue
  (``depth_threshold``) forms immediately, on the greedy path.  An
  *empty* backlog also forms immediately: in the cooperative submit/step
  loop, arrivals only surface in the queue between steps, so an idle
  server holding is pure added latency.
* **Slack-driven batch width** — the blessed pow2 dispatch width is
  capped by the *minimum* deadline slack across members (largest blessed
  width whose EMA-predicted dispatch wall still fits), instead of always
  maxing to ``max_batch_lanes``; one tight-deadline member no longer
  rides a 64-lane dispatch it cannot afford.  Cold start predicts 0.0 —
  greedy behavior until the model has seen a dispatch.
* **Repeat-offender routing** — a per-:class:`~repro_torch.serve.coalesce
  .GroupKey` decayed counter of audit mismatches and quarantines; a key
  whose score crosses ``offender_threshold`` routes straight to the
  bit-exact sequential reference (``ok_degraded``), skipping the
  bisection dance it always loses.  Clean dispatches — including the
  routed sequential ones — decay the score back below threshold, so a
  healed key returns to batched service on its own.

The policy only ever changes *when/how wide* a group dispatches and
*which engine* serves a chronic offender — never the answer: every path
still lands on the bit-exact engines, and every fault-class resolution
(the contract table in ROADMAP.md) is policy-transparent, pinned by
``tests/test_torch_policy.py``.

:class:`Telemetry` is the policy's eyes and the operator's: queue-depth
samples, per-outcome latency percentiles, formation-hold counts, and a
decision histogram.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

from repro_torch.serve.coalesce import BLESSED_LANE_WIDTHS

__all__ = ["PolicyConfig", "ServiceModel", "AdaptivePolicy", "Telemetry"]


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Knobs for the adaptive coalescing policy (mirrored on
    :class:`~repro_torch.serve.server.ServeConfig` when ``adaptive=True``)."""

    formation_window_s: float = 0.02   # max hold awaiting peers
    depth_threshold: int = 4           # backlog >= this => form immediately
    offender_threshold: float = 3.0    # decayed score >= this => sequential
    offender_decay: float = 0.5        # score *= decay per clean dispatch

    def __post_init__(self):
        if self.formation_window_s < 0.0:
            raise ValueError(f"formation_window_s must be >= 0, got "
                             f"{self.formation_window_s!r}")
        if self.depth_threshold < 1:
            raise ValueError(f"depth_threshold must be >= 1, got "
                             f"{self.depth_threshold!r}")
        if self.offender_threshold <= 0.0:
            raise ValueError(f"offender_threshold must be > 0, got "
                             f"{self.offender_threshold!r}")
        if not 0.0 <= self.offender_decay < 1.0:
            raise ValueError(f"offender_decay must be in [0, 1), got "
                             f"{self.offender_decay!r}")


class ServiceModel:
    """Per-blessed-width EMA of coalesced dispatch wall time — the
    predictor behind slack decisions.  Widths never observed predict by
    scaling the nearest *narrower* observation linearly in lanes (an
    upper bound for a lane-batched window loop, whose wall is mostly
    width-flat), or
    borrow the narrowest observation outright; a cold model predicts 0.0,
    which makes every slack check pass — greedy behavior until data
    arrives, never a spurious refusal."""

    ALPHA = 0.2  # same decay rate as the server's admission EMA

    def __init__(self):
        self._ema: dict[int, float] = {}

    def observe(self, width: int, wall_s: float) -> None:
        wall_s = max(float(wall_s), 0.0)
        prev = self._ema.get(width)
        self._ema[width] = (wall_s if prev is None
                            else (1 - self.ALPHA) * prev + self.ALPHA * wall_s)

    def predict(self, width: int) -> float:
        """Predicted dispatch wall for a ``width``-lane blessed dispatch."""
        if width in self._ema:
            return self._ema[width]
        below = [w for w in self._ema if w < width]
        if below:
            w0 = max(below)
            return self._ema[w0] * (width / w0)
        if self._ema:
            return self._ema[min(self._ema)]
        return 0.0


class Telemetry:
    """The serve loop's measurement plane: queue-depth samples at every
    step, per-outcome latency observations (p50/p99 on demand), dispatch
    widths, formation-hold counts, and the policy decision histogram.
    Pure accumulation — no clock reads, so it is as deterministic as the
    observations fed into it."""

    def __init__(self):
        self.depth_samples: list[int] = []
        self.latency_by_outcome: dict[str, list[float]] = {}
        self.dispatch_widths: list[int] = []
        self.formation_holds = 0
        self.decisions = Counter()

    def observe_depth(self, depth: int) -> None:
        self.depth_samples.append(int(depth))

    def observe_response(self, resp) -> None:
        self.latency_by_outcome.setdefault(resp.status, []).append(
            float(resp.latency_s))

    def observe_width(self, width: int) -> None:
        self.dispatch_widths.append(int(width))

    @staticmethod
    def _percentile(sorted_xs: list[float], q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) — no numpy needed and
        exact on the small samples the serve loop accumulates."""
        if not sorted_xs:
            raise ValueError("percentile of an empty sample")
        rank = max(1, int(-(-len(sorted_xs) * q // 100)))  # ceil
        return sorted_xs[min(rank, len(sorted_xs)) - 1]

    def latency_percentiles(self) -> dict[str, dict[str, float]]:
        out = {}
        for status, xs in sorted(self.latency_by_outcome.items()):
            s = sorted(xs)
            out[status] = {"n": len(s),
                           "p50_s": self._percentile(s, 50),
                           "p99_s": self._percentile(s, 99)}
        return out

    def summary(self) -> dict:
        """One JSON-ready snapshot."""
        depths = self.depth_samples
        return {
            "steps": len(depths),
            "queue_depth": {
                "max": max(depths) if depths else 0,
                "mean": (sum(depths) / len(depths)) if depths else 0.0,
            },
            "latency_by_outcome": self.latency_percentiles(),
            "dispatch_widths": dict(Counter(self.dispatch_widths)),
            "formation_holds": self.formation_holds,
            "decisions": dict(self.decisions),
        }


class AdaptivePolicy:
    """The three adaptive decisions, stateful but tiny: a width-indexed
    :class:`ServiceModel`, a per-group-key offender score, and a decision
    counter written into the shared :class:`Telemetry`."""

    def __init__(self, cfg: PolicyConfig, telemetry: Telemetry | None = None):
        self.cfg = cfg
        self.model = ServiceModel()
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.offenders: dict = {}   # GroupKey -> decayed offense score

    def _decide(self, decision: str) -> None:
        self.telemetry.decisions[decision] += 1

    # -- slack-driven batch width ------------------------------------------

    def width_budget(self, min_slack_s: float) -> int:
        """The widest blessed lane width whose EMA-predicted dispatch wall
        fits the tightest member's deadline slack.  Monotone in slack by
        construction (the feasible set only shrinks as slack tightens),
        and never below the narrowest blessed width — a head request must
        dispatch at *some* width regardless."""
        best = BLESSED_LANE_WIDTHS[0]
        for w in BLESSED_LANE_WIDTHS:
            if self.model.predict(w) <= min_slack_s:
                best = max(best, w)
        return best

    def hold_spare(self, min_slack_s: float) -> float:
        """Seconds of formation hold the tightest member can still afford
        on top of the EMA-predicted dispatch at the slack-chosen width —
        the hard cap that keeps a hold from ever outliving a member's
        slack."""
        return min_slack_s - self.model.predict(
            self.width_budget(min_slack_s))

    # -- formation window ---------------------------------------------------

    def formation_window(self, *, depth: int, lanes: int, lane_budget: int,
                         min_slack_s: float) -> float:
        """How long the freshly formed group should hold for more peers
        (0.0 = dispatch now).  ``depth`` is the backlog length behind the
        head at step entry; ``lanes``/``lane_budget`` the group's current
        and maximum lane occupancy; ``min_slack_s`` the tightest member's
        time-to-deadline.  The returned window is capped so that window +
        predicted dispatch never exceeds any member's slack."""
        if depth >= self.cfg.depth_threshold:
            self._decide("immediate_deep_queue")
            return 0.0
        if depth == 0:
            # Cooperative loop: nothing queued behind the head means no
            # concurrent load — peers cannot materialize mid-step, so a
            # hold is pure latency.  This is what keeps adaptive depth-1
            # p50 at the greedy baseline.
            self._decide("immediate_no_backlog")
            return 0.0
        if lanes >= lane_budget:
            self._decide("immediate_group_full")
            return 0.0
        window = min(self.cfg.formation_window_s,
                     self.hold_spare(min_slack_s))
        if window <= 0.0:
            self._decide("immediate_slack")
            return 0.0
        self._decide("hold")
        return window

    # -- repeat-offender routing -------------------------------------------

    def record_offense(self, key) -> None:
        """An audit mismatch or quarantine under ``key``: bump its score."""
        self.offenders[key] = self.offenders.get(key, 0.0) + 1.0

    def record_clean(self, key) -> None:
        """A clean dispatch under ``key`` (batched or routed-sequential)
        decays the score — chronically failing keys heal back to batched
        routing instead of being exiled forever."""
        score = self.offenders.get(key)
        if score is None:
            return
        score *= self.cfg.offender_decay
        if score < 0.05:
            self.offenders.pop(key, None)
        else:
            self.offenders[key] = score

    def route_sequential(self, key) -> bool:
        """True when ``key`` has failed enough audits/quarantines that
        batching it again is wasted bisection work: serve it on the
        bit-exact sequential reference until the score decays."""
        return self.offenders.get(key, 0.0) >= self.cfg.offender_threshold
