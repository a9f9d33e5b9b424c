"""Timed provider dynamics: the event language of the scenario engine
(a copy of ``repro.scenarios.schedule``, unchanged in behaviour, on the
port's ``ProviderProfile``).

A :class:`ScenarioSchedule` is a sorted list of :class:`ProviderEvent`s on
a step axis of length ``horizon`` (one step = one served request / env
transition).  Event kinds:

  ``price``     provider's fee  = base fee x value
  ``drift``     provider's recall (base + sweet spots) = base x value,
                clipped to [0, 1] — accuracy degradation or improvement
  ``latency``   provider's latency = base latency x value (spikes)
  ``outage``    provider hard-down: empty detections, zero fee, timeout
                latency if selected
  ``recovery``  cancels an outage
  ``arrival``   a NEW provider (event carries its profile) joins the pool;
                before its arrival step the slot exists but is inactive,
                so the action space is fixed for the whole scenario
  ``demand``    the request mix concentrates on images containing the
                given categories (comma-joined; "" resets to uniform)

Values are multipliers **against the base profile** (latest event per
(kind, provider) wins), so regimes compose predictably and returning to
``value=1.0`` restores the base state exactly — which the provider pool
exploits to re-hit warm evaluation caches.

Built-in scenarios (``price_war``, ``provider_outage``, ``accuracy_drift``,
``flash_crowd``, ``provider_churn``) live in ``BUILTIN_SCENARIOS``;
``random_scenario`` samples a seeded composition of the same event kinds;
``build_scenario`` resolves either by name.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.federation.providers import ProviderProfile

EVENT_KINDS = ("price", "drift", "latency", "outage", "recovery",
               "arrival", "demand")


@dataclass(frozen=True)
class ProviderEvent:
    step: int
    kind: str
    provider: str = ""          # provider name; for "demand": categories
    value: float = 1.0          # multiplier vs base (or demand boost)
    profile: Optional[ProviderProfile] = None   # "arrival" payload

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r} "
                             f"(one of {EVENT_KINDS})")
        if self.kind == "arrival" and self.profile is None:
            raise ValueError("arrival events must carry a profile")
        if self.step < 0:
            raise ValueError(f"event step must be >= 0, got {self.step}")


@dataclass(frozen=True)
class PoolEffects:
    """Accumulated effect of every event at or before one step: latest
    event per (kind, provider) wins; outage/recovery toggle."""
    price: Tuple[Tuple[str, float], ...] = ()
    drift: Tuple[Tuple[str, float], ...] = ()
    latency: Tuple[Tuple[str, float], ...] = ()
    down: frozenset = frozenset()
    joined: frozenset = frozenset()
    demand: Optional[Tuple[Tuple[str, ...], float]] = None

    def as_dicts(self):
        return dict(self.price), dict(self.drift), dict(self.latency)


class ScenarioSchedule:
    """An immutable, sorted event timeline over ``horizon`` steps.

    Segment s spans ``[boundaries[s], boundaries[s+1])``; segment 0 always
    starts at step 0 (the base regime) even if the first event is later.
    Steps past the horizon clamp to the final segment, so a driver that
    overruns the schedule keeps a well-defined world.
    """

    def __init__(self, name: str, horizon: int,
                 events: Sequence[ProviderEvent]):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        bad = [e for e in events if e.step >= horizon]
        if bad:
            raise ValueError(f"events past the horizon ({horizon}): {bad}")
        self.name = name
        self.horizon = int(horizon)
        self.events: Tuple[ProviderEvent, ...] = tuple(
            sorted(events, key=lambda e: e.step))
        self.boundaries: List[int] = sorted(
            {0} | {e.step for e in self.events})

    @property
    def n_segments(self) -> int:
        return len(self.boundaries)

    def clamp(self, step: int) -> int:
        return min(max(int(step), 0), self.horizon - 1)

    def segment_index(self, step: int) -> int:
        return bisect.bisect_right(self.boundaries, self.clamp(step)) - 1

    def segment_range(self, seg: int) -> Tuple[int, int]:
        """[start, end) step range of segment ``seg``."""
        start = self.boundaries[seg]
        end = (self.boundaries[seg + 1] if seg + 1 < self.n_segments
               else self.horizon)
        return start, end

    def arrivals(self) -> List[ProviderProfile]:
        """Every arriving provider's profile, in event order — the pool
        pre-allocates their action slots so the action space is static."""
        return [e.profile for e in self.events if e.kind == "arrival"]

    def effects_at(self, step: int) -> PoolEffects:
        price: Dict[str, float] = {}
        drift: Dict[str, float] = {}
        latency: Dict[str, float] = {}
        down: set = set()
        joined: set = set()
        demand: Optional[Tuple[Tuple[str, ...], float]] = None
        t = self.clamp(step)
        for ev in self.events:
            if ev.step > t:
                break
            if ev.kind == "price":
                price[ev.provider] = ev.value
            elif ev.kind == "drift":
                drift[ev.provider] = ev.value
            elif ev.kind == "latency":
                latency[ev.provider] = ev.value
            elif ev.kind == "outage":
                down.add(ev.provider)
            elif ev.kind == "recovery":
                down.discard(ev.provider)
            elif ev.kind == "arrival":
                joined.add(ev.profile.name)
            elif ev.kind == "demand":
                cats = tuple(c.strip() for c in ev.provider.split(",")
                             if c.strip())
                demand = (cats, ev.value) if cats else None
        return PoolEffects(tuple(sorted(price.items())),
                           tuple(sorted(drift.items())),
                           tuple(sorted(latency.items())),
                           frozenset(down), frozenset(joined), demand)

    def describe(self) -> str:
        lines = [f"scenario {self.name!r}: horizon={self.horizon} "
                 f"segments={self.n_segments}"]
        for ev in self.events:
            tgt = ev.provider or (ev.profile.name if ev.profile else "*")
            lines.append(f"  t={ev.step:>5d}  {ev.kind:<8s} {tgt} "
                         f"x{ev.value:g}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Built-in scenarios.  Each takes the BASE provider list and a horizon and
# places events at fixed fractions, so one scenario scales to any budget.
# ---------------------------------------------------------------------------

def price_war(providers: Sequence[ProviderProfile], *,
              horizon: int = 1200) -> ScenarioSchedule:
    """Two providers undercut each other, then prices normalize.

    Detections never change, so every regime shares ONE warm evaluation
    cache — the pure test of cost-sensitivity under re-pricing."""
    a, b = providers[0].name, providers[1 % len(providers)].name
    h = horizon
    return ScenarioSchedule("price_war", h, [
        ProviderEvent(h // 4, "price", a, 0.25),
        ProviderEvent(h // 2, "price", a, 1.0),
        ProviderEvent(h // 2, "price", b, 0.2),
        ProviderEvent(3 * h // 4, "price", a, 1.8),
        ProviderEvent(3 * h // 4, "price", b, 1.0),
    ])


def provider_outage(providers: Sequence[ProviderProfile], *,
                    horizon: int = 1200) -> ScenarioSchedule:
    """The strongest base provider hard-fails mid-stream and later
    recovers; a latency spike precedes the failure (brown-out)."""
    victim = max(providers, key=lambda p: p.base_recall).name
    h = horizon
    return ScenarioSchedule("provider_outage", h, [
        ProviderEvent(h // 4, "latency", victim, 6.0),
        ProviderEvent(h // 3, "outage", victim),
        ProviderEvent(2 * h // 3, "recovery", victim),
        ProviderEvent(2 * h // 3, "latency", victim, 1.0),
    ])


def accuracy_drift(providers: Sequence[ProviderProfile], *,
                   horizon: int = 1200) -> ScenarioSchedule:
    """One provider's recall decays in two steps while another's improves,
    then both revert — the w/o-retraining model-rot regime."""
    a = providers[0].name
    b = providers[1 % len(providers)].name
    h = horizon
    return ScenarioSchedule("accuracy_drift", h, [
        ProviderEvent(h // 4, "drift", a, 0.7),
        ProviderEvent(h // 2, "drift", a, 0.5),
        ProviderEvent(h // 2, "drift", b, 1.35),
        ProviderEvent(3 * h // 4, "drift", a, 1.0),
        ProviderEvent(3 * h // 4, "drift", b, 1.0),
    ])


def flash_crowd(providers: Sequence[ProviderProfile], *,
                horizon: int = 1200) -> ScenarioSchedule:
    """The request mix concentrates on the Azure sweet-spot categories
    (paper Fig. 1: bottle/cup/dining-table are AWS blind spots), then
    returns to uniform.  Providers are untouched — the SAME evaluation
    cache serves every regime; only the traffic distribution moves."""
    h = horizon
    return ScenarioSchedule("flash_crowd", h, [
        ProviderEvent(h // 3, "demand", "bottle,cup,dining table", 8.0),
        ProviderEvent(2 * h // 3, "demand", "", 1.0),
    ])


def provider_churn(providers: Sequence[ProviderProfile], *,
                   horizon: int = 1200) -> ScenarioSchedule:
    """A mid-tier provider churns out for good; a stronger, pricier
    challenger launches later."""
    leaver = providers[-1].name
    challenger = ProviderProfile(
        name="challenger", base_recall=0.82, box_jitter=0.018, fp_rate=0.4,
        score_mu=0.80, cost_milli_usd=1.6, dialect=1, latency_ms=280.0)
    h = horizon
    return ScenarioSchedule("provider_churn", h, [
        ProviderEvent(2 * h // 5, "outage", leaver),
        ProviderEvent(3 * h // 5, "arrival", profile=challenger),
    ])


def random_scenario(providers: Sequence[ProviderProfile], *,
                    horizon: int = 1200, seed: int = 0,
                    n_events: int = 6) -> ScenarioSchedule:
    """Seeded random composition of the built-in event kinds.

    Outages always schedule a matching recovery and never take the pool
    below two live providers; values are drawn from the same ranges the
    built-ins use, so random scenarios stay in-distribution."""
    rng = np.random.default_rng(seed)
    names = [p.name for p in providers]
    cat_pool = ["person", "chair", "car", "cup", "bottle", "dining table",
                "book", "handbag"]
    steps = sorted(int(s) for s in
                   rng.integers(horizon // 5, horizon - 1, n_events))
    events: List[ProviderEvent] = []
    down: Dict[str, int] = {}       # name -> recovery step
    for t in steps:
        kind = str(rng.choice(["price", "drift", "latency", "outage",
                               "demand"]))
        name = str(rng.choice(names))
        if kind == "price":
            events.append(ProviderEvent(
                t, "price", name, float(np.exp(rng.uniform(
                    np.log(0.2), np.log(3.0))))))
        elif kind == "drift":
            events.append(ProviderEvent(
                t, "drift", name, float(rng.uniform(0.4, 1.3))))
        elif kind == "latency":
            events.append(ProviderEvent(
                t, "latency", name, float(rng.uniform(0.5, 6.0))))
        elif kind == "outage":
            down_now = [n for n, r in down.items() if r > t]
            if name in down_now or len(names) - len(down_now) <= 2:
                continue            # never drop below two live providers
            recover = int(min(horizon - 1,
                              t + rng.integers(horizon // 8, horizon // 3)))
            events.append(ProviderEvent(t, "outage", name))
            if recover > t:
                events.append(ProviderEvent(recover, "recovery", name))
            down[name] = recover
        else:
            k = int(rng.integers(1, 3))
            cats = ",".join(rng.choice(cat_pool, size=k, replace=False))
            events.append(ProviderEvent(
                t, "demand", cats, float(rng.uniform(3.0, 10.0))))
    return ScenarioSchedule(f"random-{seed}", horizon, events)


BUILTIN_SCENARIOS = {
    "price_war": price_war,
    "provider_outage": provider_outage,
    "accuracy_drift": accuracy_drift,
    "flash_crowd": flash_crowd,
    "provider_churn": provider_churn,
}


def build_scenario(name: str, providers: Sequence[ProviderProfile], *,
                   horizon: int = 1200, seed: int = 0) -> ScenarioSchedule:
    """Resolve a scenario by name: a built-in, or ``random`` /
    ``random:<seed>`` for the seeded generator."""
    if name.startswith("random"):
        _, _, s = name.partition(":")
        return random_scenario(providers, horizon=horizon,
                               seed=int(s) if s else seed)
    if name in BUILTIN_SCENARIOS:
        return BUILTIN_SCENARIOS[name](providers, horizon=horizon)
    raise ValueError(f"unknown scenario {name!r} (built-ins: "
                     f"{', '.join(BUILTIN_SCENARIOS)}, or random[:seed])")
