"""Synthetic function-calling workload: BFCL/GeoEngine stand-in.

The port's copy of `repro.data.workload`, line for line. The real
benchmarks are not bundled, so we generate a tool catalog and query stream
with the same *shape* as the paper's mix (§IV): single-call queries
(BFCL-like) and multi-step chains of 2–4 sequential calls (GeoEngine-like),
over a catalog large enough that naive all-tools prompting degrades
small-model accuracy — the regime the paper's tool selection targets.

Every query carries ground-truth tool ids so selection accuracy is measurable,
an entity span for the NER/keyword path, and a difficulty class that the
runtime's TPS simulation maps to output lengths.

QoS tiers: real traffic is not uniform — an assistant turn blocking a user
(interactive) competes with background agents (standard) and offline batch
jobs. `QoSTier` names a priority class with a queue-wait deadline budget and
an arrival share; a tiered `FunctionCallWorkload` stamps each `Query` with
its tier, which the runtime maps onto `SessionRequest(priority=,
deadline_s=)` and the fleet router uses for deadline-aware placement. With
`tiers=None` (the default) nothing changes: every query arrives untiered
(priority 0, no deadline) and the sampling rng stream is untouched, so
pre-tier results stay bit-identical.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

DOMAINS = [
    ("weather", ["forecast", "temperature", "humidity", "wind", "alerts"]),
    ("maps", ["route", "distance", "traffic", "nearby", "elevation"]),
    ("calendar", ["event", "reminder", "availability", "meeting", "schedule"]),
    ("finance", ["price", "exchange", "portfolio", "invoice", "budget"]),
    ("email", ["send", "search", "draft", "attachment", "label"]),
    ("media", ["play", "playlist", "volume", "podcast", "lyrics"]),
    ("smart_home", ["lights", "thermostat", "lock", "camera", "vacuum"]),
    ("travel", ["flight", "hotel", "rental", "visa", "itinerary"]),
    ("health", ["steps", "heart_rate", "sleep", "calories", "workout"]),
    ("geo", ["geocode", "reverse_geocode", "timezone", "terrain", "satellite"]),
]
ACTIONS = ["get", "set", "search", "create", "update", "delete", "list", "compare"]
ENTITIES = ["Chicago", "Berlin", "Tokyo", "Nairobi", "Oslo", "Lima", "Sydney",
            "Austin", "Carbondale", "Zurich", "Mumbai", "Seoul"]

QUERY_TEMPLATES = [
    "Can you {action} the {topic} for {entity}?",
    "I need to {action} {topic} near {entity} today",
    "{action} {topic} information about {entity} please",
    "What is the {topic} in {entity}? Please {action} it",
    "Help me {action} a {topic} regarding {entity}",
]

PARAPHRASE_NOISE = ["", " right away", " as soon as possible", " thanks",
                    " when you get a chance", " for my trip"]


@dataclasses.dataclass(frozen=True)
class Tool:
    tool_id: int
    name: str
    description: str
    keywords: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class QoSTier:
    """One priority class of the workload mix.

    `priority` feeds `SessionRequest.priority` (larger admits first and may
    preempt strictly smaller); `deadline_s` is the queue-wait budget
    (`SessionRequest.deadline_s`; None = no deadline); `share` is the tier's
    fraction of arrivals; `latency_weight` scales how strongly the fleet
    router penalizes predicted queue wait for this tier (batch traffic sets
    it near zero so placement chases low carbon instead).
    """
    name: str
    priority: int
    deadline_s: Optional[float]
    share: float
    latency_weight: float = 1.0


# The canonical three-tier mix: latency-bound user turns, background agent
# traffic with slack, and deadline-free offline jobs that exist to soak up
# low-carbon capacity (and to be preempted under pool pressure).
DEFAULT_TIERS: Tuple[QoSTier, ...] = (
    QoSTier("interactive", priority=2, deadline_s=60.0, share=0.30,
            latency_weight=4.0),
    QoSTier("standard", priority=1, deadline_s=600.0, share=0.50,
            latency_weight=1.0),
    QoSTier("batch", priority=0, deadline_s=None, share=0.20,
            latency_weight=0.001),
)

TIERS_BY_NAME: Dict[str, QoSTier] = {t.name: t for t in DEFAULT_TIERS}


def parse_qos_mix(spec: str) -> Tuple[QoSTier, ...]:
    """Parse "interactive:0.3,standard:0.5,batch:0.2" into QoSTiers with the
    given arrival shares (names must come from DEFAULT_TIERS; shares are
    normalized, so integer weights work too)."""
    parts = []
    for item in spec.split(","):
        name, _, w = item.strip().partition(":")
        if name not in TIERS_BY_NAME:
            raise ValueError(f"unknown QoS tier {name!r}; expected one of "
                             f"{sorted(TIERS_BY_NAME)}")
        weight = float(w) if w else 1.0
        if weight <= 0:
            raise ValueError(f"QoS tier {name!r} needs a positive share, "
                             f"got {weight}")
        parts.append((TIERS_BY_NAME[name], weight))
    total = sum(w for _, w in parts)
    return tuple(dataclasses.replace(t, share=w / total) for t, w in parts)


def diurnal_qph(base_qph: float, t_s: float, *, peak: float = 1.6,
                trough: float = 0.4) -> float:
    """Diurnal arrival-rate modulation for fleet-scale runs: traffic swells
    to `peak` x base in the afternoon (~15:00) and sags to `trough` x base
    overnight — the pattern that makes lazy pod construction and regional
    shedding worth having (a 64-pod fleet sized for the peak idles most of
    its pods at night). Pass as `run_fleet(rate_fn=...)` via
    ``functools.partial`` or a lambda over the base rate."""
    hod = (t_s / 3600.0) % 24.0
    # cosine day-curve: minimum at 03:00, maximum at 15:00
    phase = (1.0 - math.cos(2.0 * math.pi * (hod - 3.0) / 24.0)) / 2.0
    return base_qph * (trough + (peak - trough) * phase)


@dataclasses.dataclass(frozen=True)
class Query:
    text: str
    sentences: Tuple[str, ...]
    true_tools: Tuple[int, ...]      # ordered chain of ground-truth tool ids
    entities: Tuple[str, ...]
    difficulty: str                  # "single" (BFCL-like) | "chain" (GeoEngine-like)
    tier: Optional[QoSTier] = None   # None = untiered (priority 0, no deadline)


@dataclasses.dataclass
class ToolCatalog:
    tools: List[Tool]

    @property
    def texts(self) -> List[str]:
        return [t.description for t in self.tools]

    def keyword_map(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for t in self.tools:
            for k in t.keywords:
                out.setdefault(k.lower(), []).append(t.tool_id)
        return out


def build_catalog(num_tools: int = 240, seed: int = 0) -> ToolCatalog:
    rng = random.Random(seed)
    combos = [(d, t, a) for d, topics in DOMAINS for t in topics for a in ACTIONS]
    rng.shuffle(combos)
    tools = []
    for i, (domain, topic, action) in enumerate(combos[:num_tools]):
        name = f"{domain}_{action}_{topic}"
        desc = (f"{action} {topic} data in the {domain} domain. "
                f"Use this to {action} {topic} for a given location or item.")
        tools.append(Tool(tool_id=i, name=name, description=desc,
                          keywords=(domain, topic, action)))
    return ToolCatalog(tools)


@dataclasses.dataclass
class FunctionCallWorkload:
    catalog: ToolCatalog
    seed: int = 0
    chain_fraction: float = 0.35     # GeoEngine-like share of the mix
    tiers: Optional[Sequence[QoSTier]] = None   # None = untiered traffic

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        # tier assignment draws from its OWN rng: the query-content stream is
        # identical with and without tiers (same seed -> same prompts), so a
        # tiered run and its priority-0 baseline compare the same traffic
        self._tier_rng = random.Random(self.seed + 0x7ee5)
        if self.tiers:
            self._tier_cum = []
            acc = 0.0
            for t in self.tiers:
                acc += t.share
                self._tier_cum.append(acc)

    def _draw_tier(self) -> Optional[QoSTier]:
        if not self.tiers:
            return None
        u = self._tier_rng.random() * self._tier_cum[-1]
        for t, edge in zip(self.tiers, self._tier_cum):
            if u < edge:
                return t
        return self.tiers[-1]

    def _query_for(self, tool: Tool, rng) -> str:
        domain, topic, action = tool.keywords
        tpl = rng.choice(QUERY_TEMPLATES)
        ent = rng.choice(ENTITIES)
        return tpl.format(action=action, topic=topic, entity=ent) + \
            rng.choice(PARAPHRASE_NOISE), ent

    def sample(self) -> Query:
        rng = self._rng
        tier = self._draw_tier()
        if rng.random() < self.chain_fraction:
            n = rng.randint(2, 4)
            tools = rng.sample(self.catalog.tools, n)
            parts, ents = [], []
            for t in tools:
                s, e = self._query_for(t, rng)
                parts.append(s)
                ents.append(e)
            text = ". ".join(parts)
            return Query(text=text, sentences=tuple(parts),
                         true_tools=tuple(t.tool_id for t in tools),
                         entities=tuple(ents), difficulty="chain", tier=tier)
        t = rng.choice(self.catalog.tools)
        s, e = self._query_for(t, rng)
        return Query(text=s, sentences=(s,), true_tools=(t.tool_id,),
                     entities=(e,), difficulty="single", tier=tier)

    def stream(self, n: int) -> List[Query]:
        return [self.sample() for _ in range(n)]
