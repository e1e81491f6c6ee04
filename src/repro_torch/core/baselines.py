"""The paper's comparison methods (§IV) as Policy configurations.

  Default — all tools in the prompt, max power mode, fixed Q8.
  Gorilla — retrieval-only tool filtering (no rerank/NER), m1, fixed Q8.
  LiS     — LLM-recommender selection (extra inference), m1, fixed Q8.
  LiS*    — LiS selection + carbon-aware modes, but NO variant switching.
  CarbonCall — full system.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.runtime import Policy

POLICIES: Dict[str, Policy] = {
    "default": Policy(name="default", use_selection="all_tools",
                      carbon_modes=False, variant_switching=False),
    "gorilla": Policy(name="gorilla", use_selection="gorilla",
                      carbon_modes=False, variant_switching=False),
    "lis": Policy(name="lis", use_selection="lis",
                  carbon_modes=False, variant_switching=False),
    "lis_star": Policy(name="lis_star", use_selection="lis",
                       carbon_modes=True, variant_switching=False),
    "carboncall": Policy(name="carboncall", use_selection="carboncall",
                         carbon_modes=True, variant_switching=True),
}
