"""The port's serving stack. Names load on first use (a module `__getattr__`),
so `repro_torch.serving.protocol` and the worker launcher
(`repro_torch.launch.workers`) import without torch: a spawned worker
imports them before it touches the card."""
import importlib

_MODULES = {
    "block_pool": ("BlockPool", "PrefixCache", "PrefixEntry"),
    "engine": ("EngineClient", "Request", "ServingEngine", "VirtualClock"),
    "invariants": ("check_invariants",),
    "protocol": ("PROTOCOL_VERSION", "STATS_SCHEMA_VERSION", "EngineConfig",
                 "EngineStats", "ProtocolError", "QuerySpec", "RequestResult",
                 "SpecDecodeConfig", "WorkerSpec",
                 "session_request_from_wire", "session_request_to_wire"),
    "sampler": ("sample_tokens",),
    "scheduler": ("DeadlineExpiredError", "EngineStallError",
                  "PoolExhaustedError", "RequestCancelledError",
                  "RequestHandle", "Scheduler", "SessionRequest"),
}
_HOME = {name: mod for mod, names in _MODULES.items() for name in names}

__all__ = ["BlockPool", "PrefixCache", "PrefixEntry", "ServingEngine",
           "EngineClient", "Request", "RequestHandle", "Scheduler",
           "SessionRequest", "VirtualClock", "EngineStallError",
           "PoolExhaustedError", "DeadlineExpiredError",
           "RequestCancelledError", "sample_tokens",
           "PROTOCOL_VERSION", "STATS_SCHEMA_VERSION", "EngineConfig",
           "EngineStats", "ProtocolError", "QuerySpec", "RequestResult",
           "SpecDecodeConfig", "WorkerSpec", "session_request_from_wire",
           "session_request_to_wire", "check_invariants"]


def __getattr__(name):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
