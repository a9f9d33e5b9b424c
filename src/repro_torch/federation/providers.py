"""Simulated MLaaS provider profiles.

The offline container cannot call AWS/Azure/GCP, so providers are simulated
with skill profiles calibrated to the paper's measurements (Sec. II):
AWS leads overall but returns nothing on bottle/cup/dining-table; Azure is
weakest on average yet best on exactly those categories; Google leads on
"book".  Every provider speaks its own label dialect (exercising the word
grouping stage) and charges 0.001 USD per request.

``scalability_providers`` reproduces the Tab. III setting: AWS/Azure/Google/
Alibaba + six synthetic services, one of which (MLaaS 5) is 20-30 AP50
points better than the rest.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.federation.vocab import COCO_TEMPLATE

# categories the paper calls out explicitly
_AWS_BLIND = {"bottle", "cup", "dining table"}
_AWS_SWEET = {"person", "chair", "car", "handbag"}
_AZURE_SWEET = {"cup", "bottle", "dining table"}
_GOOGLE_SWEET = {"book"}


@dataclass(frozen=True)
class ProviderProfile:
    """Immutable provider snapshot.

    Frozen on purpose: profiles are consumed as value objects by trace
    generation and the memoized subset-evaluation caches, so in-place
    mutation (e.g. by a scenario schedule) would silently alias cached
    state.  Derive variants through :meth:`replace`, which bumps ``rev``
    so two snapshots of the same provider are distinguishable, and key
    caches on :meth:`fingerprint`.
    """
    name: str
    base_recall: float
    sweet: Dict[str, float] = field(default_factory=dict)   # cat -> recall
    blind: frozenset = frozenset()
    box_jitter: float = 0.03
    fp_rate: float = 0.5            # expected false positives per image
    score_mu: float = 0.75
    score_sigma: float = 0.12
    cost_milli_usd: float = 1.0     # 0.001 USD per request
    dialect: int = 0                # which synonym variant this provider emits
    latency_ms: float = 350.0
    rev: int = 0                    # bumped by replace(): snapshot version

    def recall_for(self, category: str) -> float:
        if category in self.blind:
            return 0.0
        return self.sweet.get(category, self.base_recall)

    def replace(self, **changes) -> "ProviderProfile":
        """A new snapshot with ``changes`` applied and ``rev`` bumped
        (unless the caller pins ``rev`` explicitly)."""
        changes.setdefault("rev", self.rev + 1)
        return dataclasses.replace(self, **changes)

    def fingerprint(self, *, detection_only: bool = False) -> Tuple:
        """Hashable identity of this snapshot's behavior.

        ``detection_only=True`` drops the economic fields (cost, latency)
        and ``rev``, leaving exactly the knobs that shape the provider's
        detection stream — the cache key for regenerated traces.
        """
        fp = (self.name, self.base_recall,
              tuple(sorted(self.sweet.items())),
              tuple(sorted(self.blind)), self.box_jitter, self.fp_rate,
              self.score_mu, self.score_sigma, self.dialect)
        if detection_only:
            return fp
        return fp + (self.cost_milli_usd, self.latency_ms)


def default_providers() -> List[ProviderProfile]:
    aws = ProviderProfile(
        name="aws", base_recall=0.62,
        sweet={c: 0.78 for c in _AWS_SWEET}, blind=frozenset(_AWS_BLIND),
        box_jitter=0.025, fp_rate=1.6, dialect=0, latency_ms=320.0)
    azure = ProviderProfile(
        name="azure", base_recall=0.42,
        sweet={c: 0.80 for c in _AZURE_SWEET},
        box_jitter=0.045, fp_rate=2.2, score_mu=0.68, dialect=1,
        latency_ms=380.0)
    google = ProviderProfile(
        name="google", base_recall=0.50,
        sweet={c: 0.78 for c in _GOOGLE_SWEET},
        box_jitter=0.035, fp_rate=1.9, score_mu=0.71, dialect=2,
        latency_ms=410.0)
    return [aws, azure, google]


def scalability_providers() -> List[ProviderProfile]:
    """AWS/Azure/Google + Alibaba + six synthetic MLaaSes (Tab. III)."""
    base = default_providers()
    ali = ProviderProfile(name="alibaba", base_recall=0.68, box_jitter=0.03,
                          fp_rate=0.5, dialect=0, latency_ms=300.0)
    synth = []
    # (base_recall, jitter, fp) tuned so AP50 spans ~20..55 with MLaaS 5 on top
    for i, (rec, jit, fp) in enumerate([
            (0.80, 0.020, 0.30),    # MLaaS 4 — strong
            (0.92, 0.012, 0.15),    # MLaaS 5 — 20-30 points above the rest
            (0.34, 0.060, 0.90),    # MLaaS 6 — weak
            (0.88, 0.015, 0.20),    # MLaaS 7 — strong
            (0.40, 0.055, 0.80),    # MLaaS 8 — weak
            (0.56, 0.035, 0.50)]):  # MLaaS 9 — mid
        synth.append(ProviderProfile(
            name=f"mlaas{i + 4}", base_recall=rec, box_jitter=jit,
            fp_rate=fp, dialect=(i % 3), latency_ms=250.0 + 40 * i))
    return base + [ali] + synth


def lattice_stress_providers(n: int = 12) -> List[ProviderProfile]:
    """``n``-provider roster for full-lattice stress runs (N > 10).

    Extends :func:`scalability_providers` with deterministic synthetic
    services whose skill spreads mirror the Tab.-III synthetics, so an
    N=12 exact oracle exercises 4095 subsets per image without inventing
    a new calibration story.
    """
    roster = scalability_providers()
    if n <= len(roster):
        return roster[:n]
    # same (recall, jitter, fp) palette as the Tab.-III synthetics,
    # cycled deterministically — no RNG, rosters are reproducible
    palette = [(0.72, 0.025, 0.40), (0.48, 0.045, 0.70),
               (0.64, 0.030, 0.45), (0.36, 0.058, 0.85)]
    for i in range(len(roster), n):
        rec, jit, fp = palette[(i - len(roster)) % len(palette)]
        roster.append(ProviderProfile(
            name=f"mlaas{i}", base_recall=rec, box_jitter=jit,
            fp_rate=fp, dialect=(i % 3), latency_ms=240.0 + 35 * i))
    return roster


def provider_names(profiles: List[ProviderProfile]) -> List[str]:
    return [p.name for p in profiles]


ALL_CATEGORIES = list(COCO_TEMPLATE)
