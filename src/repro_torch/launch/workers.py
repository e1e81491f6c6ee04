"""Multi-process fleet workers behind the frozen engine control protocol.

The port of `repro.launch.workers`. One worker process per pod/region, each
owning a full `ServingEngine` (or an `EngineExecutor` around one) and
speaking the small serializable control protocol from
`serving/protocol.py` over a multiprocessing pipe:

    parent                          worker process
    ------                          --------------
    WorkerSpec.to_wire()  ───────▶  _worker_main: build engine, handshake
    {"op": "submit", request: …} ▶  EngineActor.handle("submit") → {"rid": …}
    {"op": "settle", rids: […]}  ▶  …run engine… → RequestResult wires
    {"op": "stats"}              ▶  EngineStats.to_wire()
    {"op": "shutdown"}           ▶  reply + exit

Every request crosses the boundary as a plain dict of primitives — no
tensors, no callables, no live engine references — so the port's wire is
the reference's, message for message. Workers are spawned with the
**spawn** start method: CUDA does not survive a fork.

Where the port departs from the reference:
  * the device a worker serves on (the card unless the caller asks for the
    CPU) and, for an executor-mode worker, an optional full-width model
    config are arguments of the spawned process, not `WorkerSpec` fields,
    so the wire stays the reference's. A raw-mode worker's model config
    travels in the spec, as in the reference;
  * the worker's hardware registry holds the Orin board only: the TPU spec
    comes with the launch tail (ROADMAP Queue 1 item 9);
  * before a card worker is spawned the parent builds the kernels, so each
    worker loads the built libraries instead of running nvcc; a worker that
    cannot reach the card or load a kernel ships the error in its ready
    reply, and `launch_workers` raises, as for any build failure;
  * the ready reply also carries the worker's start-up seconds
    (`ready_s`: spawn, CUDA start-up, engine build), which the reference's
    parent ignores.

The virtual clock stays PER-WORKER, as in the reference: `rebase` pins a
worker's clock to the fleet schedule before a settle round, and `stats`
ships the timeline position back alongside the `EngineStats` payload.

This module imports the standard library and `serving.protocol` only, so it
imports without torch: the spawn child imports it to locate `_worker_main`
and loads torch once it runs.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.serving.protocol import (PROTOCOL_VERSION, EngineConfig,
                                          EngineStats, ProtocolError,
                                          QuerySpec, RequestResult,
                                          WorkerSpec,
                                          session_request_from_wire,
                                          session_request_to_wire)

# how long a parent waits for a worker's ready handshake by default: a
# full-width worker draws its weights on the card, and a cold kernel cache
# is built by the parent first
READY_TIMEOUT_S = 600.0
CALL_TIMEOUT_S = 600.0


def _model_config(d: Dict[str, Any]):
    """A port `ModelConfig` from its `dataclasses.asdict` form. Fields the
    port's config does not have (other families' options, ROADMAP Queue 1
    item 7) are refused by name."""
    from repro_torch.config import ModelConfig, SSMConfig

    known = {f.name for f in dataclasses.fields(ModelConfig)}
    extra = sorted(set(d) - known)
    if extra:
        raise ProtocolError(f"model_cfg fields the port does not serve: "
                            f"{extra} (ROADMAP Queue 1 item 7)")
    d = dict(d)
    if isinstance(d.get("ssm"), dict):
        d["ssm"] = SSMConfig(**d["ssm"])
    return ModelConfig(**d)


def _epoch_s() -> float:
    """The epoch clock, read only for the ready reply's start-up seconds."""
    return time.time()  # cc-lint: disable=CC001 -- start-up seconds for the log; no engine output reads them


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


class EngineActor:
    """Op dispatcher around one engine — the worker-side half of the control
    protocol, also drivable in-process.

    Construction follows `WorkerSpec`: raw mode (`model_cfg` set) builds a
    bare `ServingEngine` from the serialized model config, its Q8 / Q4
    trees drawn from `spec.seed` on a generator on `device`; executor mode
    builds an `EngineExecutor` (at `model_cfg`, a port `ModelConfig`, when
    given, else the reduced `spec.arch`) so the full CarbonCall query
    surface is reachable over the wire.
    """

    def __init__(self, spec: WorkerSpec, *, device="cuda", model_cfg=None):
        self.spec = spec
        self.handles: Dict[int, Any] = {}      # rid -> RequestHandle
        self.queries: Dict[int, Any] = {}      # qid -> EngineSession
        self._next_qid = 0
        self.executor = None
        if spec.model_cfg is not None:
            self._build_raw(spec, device)
        else:
            self._build_executor(spec, device, model_cfg)

    # -- construction -------------------------------------------------------

    def _build_raw(self, spec: WorkerSpec, device):
        import torch

        from repro_torch.config import RuntimeConfig
        from repro_torch.models import get_model
        from repro_torch.quant.qtensor import init_quantized
        from repro_torch.serving.engine import ServingEngine, VirtualClock

        cfg = _model_config(spec.model_cfg)
        gen = torch.Generator(device=device).manual_seed(spec.seed)
        self.variants = init_quantized(get_model(cfg).param_spec(),
                                       spec.config.variants, gen, device)
        boot = spec.config.variants[0]
        self.engine = ServingEngine(cfg, self.variants[boot], RuntimeConfig(),
                                    config=spec.config, clock=VirtualClock(),
                                    device=device)
        self.engine.variant_name = boot
        self.client = self.engine.client()
        self.modes = None

    def _build_executor(self, spec: WorkerSpec, device, model_cfg):
        from repro_torch.common.hardware import ORIN_AGX
        from repro_torch.core.engine_executor import EngineExecutor
        from repro_torch.core.executor import PAPER_MODELS
        from repro_torch.core.power import modes_for

        hw_registry = {h.name: h for h in (ORIN_AGX,)}
        if spec.hw == "tpu_v5e":
            raise ProtocolError("hardware 'tpu_v5e': the TPU spec is not "
                                "ported yet (ROADMAP Queue 1 item 9)")
        if spec.hw not in hw_registry:
            raise ProtocolError(f"unknown hardware {spec.hw!r}; expected one "
                                f"of {sorted(hw_registry)}")
        hw = hw_registry[spec.hw]
        self.executor = EngineExecutor(
            PAPER_MODELS[spec.profile], hw, arch=spec.arch, seed=spec.seed,
            config=spec.config, tokens_per_call=spec.tokens_per_call,
            eval_tokens=spec.eval_tokens, model_cfg=model_cfg, device=device)
        self.engine = self.executor.engine
        self.client = self.executor.client
        self.variants = self.executor.variants
        self.modes = modes_for(hw)

    # -- op dispatch ---------------------------------------------------------

    def handle(self, op: str, msg: Dict[str, Any]) -> Dict[str, Any]:
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            raise ProtocolError(f"unknown op {op!r}")
        return fn(msg)

    def _result_wire(self, rid: int) -> Dict[str, Any]:
        return RequestResult.from_request(
            self.handles[rid].request).to_wire()

    # engine-level ops (both modes)

    def op_submit(self, msg):
        h = self.client.submit(session_request_from_wire(msg["request"]))
        self.handles[h.rid] = h
        return {"rid": h.rid}

    def op_step(self, msg):
        done: List[int] = []
        for _ in range(int(msg.get("n", 1))):
            done.extend(r.rid for r in self.engine.step())
        return {"completed": done}

    def op_poll(self, msg):
        return {"status": self.handles[int(msg["rid"])].poll()}

    def op_cancel(self, msg):
        return {"cancelled": self.handles[int(msg["rid"])].cancel()}

    def op_swap(self, msg):
        name = msg["variant"]
        if name not in self.variants:
            raise ProtocolError(f"unknown variant {name!r}; worker holds "
                                f"{sorted(self.variants)}")
        self.engine.swap_params(self.variants[name], name)
        return {"variant": name, "swap_count": self.engine.swap_count}

    def op_advance(self, msg):
        self.engine.clock.advance(float(msg["dt"]))
        return {"t": self.engine.clock()}

    def op_rebase(self, msg):
        # fleet schedule anchor: never rewind a worker's own timeline
        self.engine.clock.t = max(self.engine.clock.t, float(msg["t"]))
        return {"t": self.engine.clock()}

    def op_clock(self, msg):
        return {"t": self.engine.clock()}

    def op_settle(self, msg):
        rids = [int(r) for r in msg["rids"]]
        self.client.settle([self.handles[r] for r in rids])
        return {"results": [self._result_wire(r) for r in rids],
                "t": self.engine.clock()}

    def op_results(self, msg):
        rids = msg.get("rids")
        if rids is None:
            rids = sorted(self.handles)
        return {"results": [self._result_wire(int(r)) for r in rids]}

    def op_drain(self, msg):
        n = 0
        for _ in range(int(msg.get("max_steps", 100_000))):
            if not self.engine.has_work():
                break
            n += len(self.engine.step())
        if self.engine.has_work():
            raise ProtocolError("engine failed to drain within step budget")
        return {"completed": n, "t": self.engine.clock()}

    def op_stats(self, msg):
        return {"stats": self.engine.stats().to_wire(),
                "t": self.engine.clock()}

    def op_check(self, msg):
        from repro_torch.serving.invariants import check_invariants
        reqs = [h.request for _, h in sorted(self.handles.items())]
        return {"violations": check_invariants(
            self.engine, reqs, flush=bool(msg.get("flush", True)))}

    def op_launches(self, msg):
        """Kernel launches in this process so far. A port-only op: a
        reference worker answers it with "unknown op"."""
        from repro_torch import kernels
        return {"launches": kernels.launch_counts()}

    # executor-level ops (the CarbonCall query surface)

    def op_query(self, msg):
        if self.executor is None:
            raise ProtocolError("query ops need an executor-mode worker "
                                "(WorkerSpec without model_cfg)")
        q = QuerySpec.from_wire(msg["query"])
        mode = self.modes[q.mode_index % len(self.modes)]
        s = self.executor.begin_query(
            n_tools_in_prompt=q.n_tools, n_calls=q.n_calls,
            selection_correct=q.selection_correct, variant=q.variant,
            mode=mode, priority=q.priority, deadline_s=q.deadline_s,
            tier=q.tier)
        qid = self._next_qid
        self._next_qid += 1
        self.queries[qid] = s
        return {"qid": qid}

    def op_settle_queries(self, msg):
        if self.executor is None:
            raise ProtocolError("query ops need an executor-mode worker")
        qids = [int(q) for q in msg["qids"]]
        sessions = [self.queries[q] for q in qids]
        self.executor.settle(sessions)
        out = [dataclasses.asdict(self.queries.pop(q).execution)
               for q in qids]
        return {"executions": out,
                "stats": self.engine.stats().to_wire(),
                "t": self.engine.clock()}


def _start_device(device: str) -> None:
    """Reach the device before building on it: a card worker checks the card
    and loads every kernel library the parent built, so a fault shows in
    the ready reply rather than at the first request."""
    import torch

    from repro_torch.common.device import resolve_device

    dev = resolve_device(device, "worker")
    if dev.type != "cuda":
        return
    torch.cuda.get_device_properties(dev)       # raises on a bad ordinal
    torch.zeros(1, device=dev)                  # starts the CUDA context
    from repro_torch.kernels import build
    build.load_all()


def _worker_main(conn, spec_wire: Dict[str, Any], device: str = "cuda",
                 model_cfg: Optional[Dict[str, Any]] = None,
                 t_spawn: Optional[float] = None) -> None:
    """Worker process entry: reach the device, build the actor, then serve
    the request/reply loop until shutdown or EOF. Runs in a SPAWNED
    interpreter. `t_spawn` is the parent's epoch clock at spawn, for the
    ready reply's spawn seconds."""
    t0 = _epoch_s()
    try:
        _start_device(device)
        t1 = _epoch_s()
        spec = WorkerSpec.from_wire(spec_wire)
        actor = EngineActor(spec, device=device, model_cfg=(
            None if model_cfg is None else _model_config(model_cfg)))
        t2 = _epoch_s()
    except BaseException as e:           # ship build failures, don't hang
        try:
            conn.send({"ok": False, "ready": True,
                       "error": f"{type(e).__name__}: {e}"})
        finally:
            conn.close()
        return
    conn.send({"ok": True, "ready": True, "protocol": PROTOCOL_VERSION,
               "label": spec.label,
               "ready_s": {"spawn": None if t_spawn is None else t0 - t_spawn,
                           "device": t1 - t0, "build": t2 - t1}})
    while True:
        try:
            msg = conn.recv()
        except (EOFError, KeyboardInterrupt):
            break                        # parent went away: exit quietly
        op = msg.get("op", "")
        if op == "shutdown":
            conn.send({"ok": True})
            break
        try:
            conn.send({"ok": True, **actor.handle(op, msg)})
        except BaseException as e:       # errors are replies, not crashes
            conn.send({"ok": False, "error": f"{type(e).__name__}: {e}"})
    conn.close()


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


class WorkerHandle:
    """Parent-side endpoint of one worker process.

    `call(op, **payload)` is the synchronous request/reply path; the
    `send`/`recv` halves are exposed separately so a fleet can dispatch one
    op to EVERY worker and then collect the replies. `device` and
    `model_cfg` (a port `ModelConfig`, executor mode) go to the spawned
    process as arguments; `ready_s` holds the worker's start-up seconds
    once it is ready.
    """

    def __init__(self, spec: WorkerSpec, *, ctx=None, device="cuda",
                 model_cfg=None):
        self.spec = spec
        self.label = spec.label or f"worker-{spec.seed}"
        self.ready_s: Optional[Dict[str, Any]] = None
        ctx = ctx if ctx is not None else mp.get_context("spawn")
        self.conn, child = ctx.Pipe()
        cfg = None if model_cfg is None else dataclasses.asdict(model_cfg)
        t_spawn = _epoch_s()
        self.proc = ctx.Process(target=_worker_main,
                                args=(child, spec.to_wire(), str(device),
                                      cfg, t_spawn), daemon=True)
        self.proc.start()
        child.close()                    # child's end lives in the child
        self._ready = False

    def wait_ready(self, timeout: float = READY_TIMEOUT_S) -> "WorkerHandle":
        """Block until the worker's handshake arrives (engine built)."""
        if self._ready:
            return self
        if not self.conn.poll(timeout):
            self.close()
            raise ProtocolError(
                f"worker {self.label!r}: no ready handshake in {timeout}s")
        try:
            msg = self.conn.recv()
        except EOFError:
            self.close()
            raise ProtocolError(
                f"worker {self.label!r} died before its handshake")
        if not msg.get("ok"):
            err = msg.get("error", "unknown failure")
            self.close()
            raise ProtocolError(f"worker {self.label!r} failed to build: "
                                f"{err}")
        if int(msg.get("protocol", -1)) != PROTOCOL_VERSION:
            self.close()
            raise ProtocolError(
                f"worker {self.label!r} speaks protocol "
                f"{msg.get('protocol')}, parent speaks {PROTOCOL_VERSION}")
        self.ready_s = msg.get("ready_s")
        self._ready = True
        return self

    # -- async halves (fan-out) ---------------------------------------------

    def send(self, op: str, **payload) -> None:
        self.wait_ready()
        self.conn.send({"op": op, "v": PROTOCOL_VERSION, **payload})

    def recv(self, timeout: float = CALL_TIMEOUT_S) -> Dict[str, Any]:
        if not self.conn.poll(timeout):
            raise ProtocolError(f"worker {self.label!r}: no reply in "
                                f"{timeout}s")
        try:
            msg = self.conn.recv()
        except EOFError:
            raise ProtocolError(f"worker {self.label!r} died mid-call")
        if not msg.get("ok"):
            raise ProtocolError(f"worker {self.label!r}: "
                                f"{msg.get('error', 'unknown error')}")
        return msg

    # -- sync conveniences ---------------------------------------------------

    def call(self, op: str, **payload) -> Dict[str, Any]:
        self.send(op, **payload)
        return self.recv()

    def submit(self, sreq) -> int:
        return self.call("submit",
                         request=session_request_to_wire(sreq))["rid"]

    def query(self, qspec: QuerySpec) -> int:
        return self.call("query", query=qspec.to_wire())["qid"]

    def settle(self, rids: Sequence[int]) -> List[RequestResult]:
        return [RequestResult.from_wire(w)
                for w in self.call("settle", rids=list(rids))["results"]]

    def stats(self) -> EngineStats:
        return EngineStats.from_wire(self.call("stats")["stats"])

    def close(self, timeout: float = 10.0) -> None:
        """Shut the worker down; escalates to terminate if it won't die."""
        try:
            if self.proc.is_alive():
                self.conn.send({"op": "shutdown", "v": PROTOCOL_VERSION})
                self.proc.join(timeout)
        except (BrokenPipeError, OSError):
            pass
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5.0)
        self.conn.close()


def _prepare_device(device) -> None:
    """Refuse a card that is not there, and build the kernels once in the
    parent so the workers only load them."""
    from repro_torch.common.device import resolve_device

    if resolve_device(device, "launch_workers").type == "cuda":
        from repro_torch.kernels import build
        build.build_all()


def launch_workers(specs: Sequence[WorkerSpec], *,
                   timeout: float = READY_TIMEOUT_S, device="cuda",
                   model_cfg=None) -> List[WorkerHandle]:
    """Spawn one worker per spec on `device` (the card unless the caller
    asks for the CPU) and wait for every handshake. All workers build their
    engines CONCURRENTLY; any build failure tears the whole set down."""
    _prepare_device(device)
    handles = [WorkerHandle(s, device=device, model_cfg=model_cfg)
               for s in specs]
    try:
        for h in handles:
            h.wait_ready(timeout)
    except BaseException:
        for h in handles:
            h.close()
        raise
    return handles


def launch_worker_fleet(fleet, *, seed: int = 0,
                        timeout: float = READY_TIMEOUT_S, device="cuda",
                        model_cfg=None) -> List[WorkerHandle]:
    """Back every pod of a built `Fleet` (or a `FleetSpec`) with its own
    executor-mode worker process on `device`: each worker receives the
    pod's serializable `EngineConfig` — the same payload `ensure_client`
    would size an in-process engine from — and is attached as `pod.worker`,
    which flips the router's predicted-wait logic onto protocol-shipped
    `EngineStats`. Returns the handles in `fleet.pods` order; callers own
    shutdown."""
    from repro_torch.core.fleet import Fleet, FleetSpec, build_fleet

    if isinstance(fleet, FleetSpec):
        fleet = build_fleet(fleet, seed=seed, device=device,
                            model_cfg=model_cfg)
    if not isinstance(fleet, Fleet):
        raise TypeError(f"launch_worker_fleet takes a Fleet or a FleetSpec, "
                        f"got {type(fleet).__name__}")
    specs = [WorkerSpec(config=(p.engine_cfg if p.engine_cfg is not None
                                else EngineConfig()),
                        seed=seed + p.pod_id,
                        label=f"{p.region}/pod{p.pod_id}")
             for p in fleet.pods]
    workers = launch_workers(specs, timeout=timeout, device=device,
                             model_cfg=model_cfg)
    for pod, w in zip(fleet.pods, workers):
        pod.worker = w
    return workers


def shutdown_workers(workers: Sequence[Optional[WorkerHandle]]) -> None:
    for w in workers:
        if w is not None:
            w.close()
