from repro_torch.serving.block_pool import BlockPool, PrefixCache, PrefixEntry
from repro_torch.serving.engine import (EngineClient, Request, ServingEngine,
                                        VirtualClock)
from repro_torch.serving.invariants import check_invariants
from repro_torch.serving.protocol import (PROTOCOL_VERSION,
                                          STATS_SCHEMA_VERSION, EngineConfig,
                                          EngineStats, ProtocolError,
                                          QuerySpec, RequestResult,
                                          SpecDecodeConfig, WorkerSpec,
                                          session_request_from_wire,
                                          session_request_to_wire)
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.scheduler import (DeadlineExpiredError,
                                           EngineStallError,
                                           PoolExhaustedError,
                                           RequestCancelledError,
                                           RequestHandle, Scheduler,
                                           SessionRequest)

__all__ = ["BlockPool", "PrefixCache", "PrefixEntry", "ServingEngine",
           "EngineClient", "Request", "RequestHandle", "Scheduler",
           "SessionRequest", "VirtualClock", "EngineStallError",
           "PoolExhaustedError", "DeadlineExpiredError",
           "RequestCancelledError", "sample_tokens",
           "PROTOCOL_VERSION", "STATS_SCHEMA_VERSION", "EngineConfig",
           "EngineStats", "ProtocolError", "QuerySpec", "RequestResult",
           "SpecDecodeConfig", "WorkerSpec", "session_request_from_wire",
           "session_request_to_wire", "check_invariants"]
