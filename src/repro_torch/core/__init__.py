"""CarbonCall core: the paper's primary contribution, on the port.

carbon.py     CI traces/forecasts + CF = E x CI accounting        (§III-A)
tool_select.py dynamic tool selection: embed -> top-k -> rerank   (§III-B)
power.py      operating-mode LUT + power/TPS model                (§III-C)
switching.py  mixed-quality Q8/Q4 variant switching               (§III-D)
governor.py   CI -> mode mapping with 10% hysteresis              (§III-E)
runtime.py    the runtime loop + weekly virtual-time driver       (§III-E, §IV)
baselines.py  Default / Gorilla / LiS / LiS* comparison policies  (§IV)
executor.py   analytic (sim) execution backend
engine_executor.py  the port's ServingEngine-backed execution backend
embedder.py   sentence encoder / cross-encoder substrate (in PyTorch)
fleet.py      multi-pod carbon-aware routing (beyond-paper scale-out)

Importing this package builds no kernel and makes no weights.
"""
from repro_torch.core.carbon import (
    WEEKS, ci_trace, forecast_trace, carbon_footprint, CarbonAccountant)
from repro_torch.core.power import (
    OperatingMode, ORIN_MODES, PowerModel, modes_for)
from repro_torch.core.governor import CarbonGovernor, GovernorState
from repro_torch.core.switching import VariantSwitcher, SwitchDecision
from repro_torch.core.tool_select import ToolSelector, SelectionResult
from repro_torch.core.runtime import (
    CarbonCallRuntime, PendingQuery, Policy, run_week, tier_report,
    WeekResult)
from repro_torch.core.baselines import POLICIES
from repro_torch.core.executor import (
    Executor, QuerySession, SimExecutor, PAPER_MODELS, ModelProfile)
from repro_torch.core.engine_executor import EngineExecutor, make_executor

__all__ = [
    "WEEKS", "ci_trace", "forecast_trace", "carbon_footprint",
    "CarbonAccountant", "OperatingMode", "ORIN_MODES",
    "PowerModel", "modes_for", "CarbonGovernor", "GovernorState",
    "VariantSwitcher", "SwitchDecision", "ToolSelector", "SelectionResult",
    "CarbonCallRuntime", "PendingQuery", "Policy", "run_week", "tier_report",
    "WeekResult",
    "POLICIES", "Executor", "QuerySession", "SimExecutor", "EngineExecutor",
    "make_executor", "PAPER_MODELS", "ModelProfile",
]
