"""Continuous-batching serving engine with a paged KV cache + prefix caching,
or a dense per-slot cache for attention-free models.

The port of `repro.serving.engine` for its two layouts. `max_batch` decode
slots; new requests prefill into free slots (prompts padded to a bucket) and
every step() decodes all active slots in one batched call. KV lives in a
block pool of `block_size`-token blocks on the device; each slot maps logical
positions to physical blocks through a host-side block table. Blocks are
refcounted (`BlockPool`) and prompt prefixes are cached (`PrefixCache`):
admission hashes the padded prompt at every block boundary, reuses already
prefilled blocks copy-on-write, and runs the model only over the non-cached
suffix. Under pool pressure the lowest-priority slot is preempted; its exact
token sequence is saved and re-prefilled at the original positions on
resume, so temperature-0 streams are unchanged. `swap_params` installs
another weight tree between steps (the CarbonCall Q8 <-> Q4 hot swap);
prefix-cache entries are salted by variant.

The paged device path: cold admissions run `transformer.prefill` (flash
attention kernel), cache hits, chunk windows and speculative verify windows
`_prefill_window` (plain `prefix_attention`), each decode step and each draft
round `decode_step_paged` (paged attention kernel), and every linear layer
the q8/q4 kernels. A CPU engine runs the kernels' plain versions, and each
of its paged decode or speculative steps counts into `kernel_fallbacks`, as
in the JAX package. The pool is updated in place.

Chunked prefill (`prefill_chunk=N`, transformer family): the queue head's
prefill runs in N-token windows, one a step, and `step()` alternates pending
prefill work with a decode step for the residents. On the paged layout N is
rounded up to whole blocks and a partial prefill is parked in the block pool
as prefix-cache entries that the next window extends; cancel, expiry, a hot
swap or pool pressure release it. On the dense layout N stays as given and
the partial prefill is parked in a slot stripe the request reserves
(`Request.chunk_slot`) until its final window admits it there; cancel,
expiry and a hot swap release the stripe. Non-final windows are logged as
"prefill_chunk" rows that emit nothing; the final window admits the request
as a "prefill" row.

Speculative decoding (`spec_decode`, paged layout): once the executor
installs the draft variant's tree (`set_draft_params`), a decode step drafts
k greedy tokens under it into leased scratch blocks, verifies the k+1 window
under the resident variant in one batched forward, accepts the longest
agreeing prefix plus the verify token, writes the accepted window's KV into
the canonical chain and returns the leases: a "spec_verify" row. It stands
down to plain decode at k = 0, without draft weights, when the draft is the
resident variant, for a non-greedy resident, near max_seq and under pool
pressure.

The dense layout (`kv_layout="dense"`, or "auto" for a family without the
paged contract) keeps one cache tree of `max_batch` slots from the model's
`cache_spec`: per-layer {conv, ssm} states for mamba2, (max_seq, K, H) KV
stripes for the transformer. An admission batch runs one padded prefill
(mamba2: the ssd kernel on the card; transformer: the flash kernel) and
copies each row's cache leaves into its slot, the transformer's written
positions at the head of the stripe and zeros after them; a decode step runs
the model's `decode_step` over every slot (transformer: plain decode
attention over the stripe, as in the JAX package) and updates the cache in
place. There is no prefix cache, copy-on-write, preemption or speculative
decoding on this layout, and no chunked prefill for mamba2 (the JAX package
refuses those two with ValueError). The data-parallel mesh is not ported
yet and is refused at construction (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.config import ModelConfig, RuntimeConfig
from repro_torch.kernels.paged_attention.ops import (
    check_shapes as check_paged_shapes, paged_attention_uses_fallback)
from repro_torch.models import get_model
from repro_torch.models.transformer import (dequant_cache, paged_block_bytes,
                                            quantize_kv_for_cache)
from repro_torch.serving.block_pool import BlockPool, PrefixCache
from repro_torch.serving.protocol import (EngineConfig, EngineStats,
                                          SpecDecodeConfig)
from repro_torch.serving.sampler import sample_tokens
from repro_torch.serving.scheduler import (
    CANCELLED, DONE, EngineStallError, PoolExhaustedError, RequestHandle,
    RUNNING, Scheduler, SessionRequest, TERMINAL, WAITING)
from repro_torch.sharding.param import init_params


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: int = 1
    temperature: float = 0.0
    priority: int = 0                      # larger runs first / preempts lower
    deadline: Optional[float] = None       # absolute engine-clock wait limit
    tier: str = "default"                  # QoS class label (telemetry only)
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    status: str = WAITING
    submit_time: float = 0.0
    enqueue_time: float = 0.0
    queue_wait_s: float = 0.0              # total time spent WAITING (all stints)
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None
    seq: int = -1                          # submission order (scheduler key)
    admit_seq: int = -1                    # admission order (victim tie-break)
    # saved token sequence (exact KV positions 0..len-1) while preempted
    resume_row: Optional[np.ndarray] = None
    # chunked-prefill progress while WAITING (cleared on admission/release):
    # the bucket-padded prompt row, how many positions are prefilled, and
    # where they live: a parked block chain (paged) or a reserved slot
    # stripe (dense)
    chunk_row: Optional[np.ndarray] = None
    chunk_done: int = 0
    chunk_blocks: List[int] = dataclasses.field(default_factory=list)
    chunk_cached: int = 0                  # real prompt tokens served from cache
    chunk_hit: bool = False
    chunk_slot: Optional[int] = None       # dense: the reserved slot stripe


class VirtualClock:
    """Deterministic virtual time source for tests and carbon simulation.
    Only `advance()` moves time."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += float(dt)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pow2(n: int, cap: int) -> int:
    """Round up to a power of two, capped. Kept from the JAX package (where
    it bounds jit executable counts) so both engines run the same padded
    shapes; the extra columns are fully masked."""
    p = 1
    while p < n:
        p <<= 1
    return min(p, cap)


def check_paged_kernel(cfg: ModelConfig, block_size: int):
    """Raise ValueError, naming what the paged decode kernel takes, when a
    CUDA engine's pool could not be read by it: a block size that is not a
    multiple of 16 up to 128, more than 8 query heads a kv head, or a head
    dim that is not a multiple of 16 up to 256."""
    kv = cfg.num_kv_heads
    check_paged_shapes(1, kv, cfg.num_heads // max(kv, 1),
                       cfg.resolved_head_dim, block_size, 1)


def refuse_unported(config: EngineConfig, mesh=None):
    """Raise NotImplementedError, naming the ROADMAP item, for the
    data-parallel mesh, which the port does not serve yet. The dense layout
    depends on the model's family and is checked by `resolve_layout`."""
    if mesh is not None or config.data_shards > 1:
        raise NotImplementedError(
            "mesh / data_shards > 1: the data-parallel engine is not "
            "ported yet (ROADMAP Queue 1 item 9)")


def resolve_layout(cfg: ModelConfig, config: EngineConfig):
    """-> (the KV layout `config` resolves to for `cfg`, its prefill window
    rounded up to whole blocks on the paged layout, or None). Raises
    ValueError where the JAX package's engine does. Reads no weights."""
    if config.kv_layout not in ("auto", "paged", "dense"):
        raise ValueError(f"unknown kv_layout {config.kv_layout!r}; "
                         "expected 'auto', 'paged' or 'dense'")
    model = get_model(cfg)
    kv_layout = config.kv_layout
    if kv_layout == "auto":
        kv_layout = "paged" if model.supports_paged() else "dense"
    if kv_layout == "paged" and not model.supports_paged():
        raise ValueError(f"{cfg.name}: family {cfg.family!r} does not "
                         "implement the paged KV contract")
    chunk = config.prefill_chunk
    if chunk is not None:
        if chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive, got {chunk}")
        if not model.supports_paged():
            raise ValueError(
                f"{cfg.name}: family {cfg.family!r} does not implement the "
                "chunked prefill contract (pattern-1 transformer families "
                "only)")
        if kv_layout == "paged":
            # block-aligned windows keep parked chains on block boundaries
            chunk = -(-chunk // config.block_size) * config.block_size
    sd = config.spec_decode
    if sd is not None:
        if kv_layout != "paged":
            raise ValueError(
                "spec_decode requires the paged KV layout: draft KV is "
                "staged in leased pool blocks")
        if sd.k < 0 or any(x < 0 for x in sd.k_ladder):
            raise ValueError("spec_decode: draft lengths must be >= 0")
    return kv_layout, chunk


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, rcfg: RuntimeConfig, *,
                 config: Optional[EngineConfig] = None,
                 max_batch: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 prompt_buckets=None,
                 kv_layout: Optional[str] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 spec_decode: Optional[SpecDecodeConfig] = None,
                 mesh=None,
                 clock: Callable[[], float] = time.monotonic,
                 step_cost_fn: Optional[Callable[[str, int, int], float]] = None,
                 device="cuda",
                 seed: int = 42):
        base = config if config is not None else EngineConfig()
        over = {k: v for k, v in (("max_batch", max_batch),
                                  ("max_seq", max_seq),
                                  ("kv_layout", kv_layout),
                                  ("block_size", block_size),
                                  ("num_blocks", num_blocks),
                                  ("prefill_chunk", prefill_chunk),
                                  ("spec_decode", spec_decode))
                if v is not None}
        if prompt_buckets is not None:
            over["prompt_buckets"] = tuple(prompt_buckets)
        self.config = config = base.replace(**over) if over else base
        refuse_unported(config, mesh)
        kv_layout, self.prefill_chunk = resolve_layout(cfg, config)
        # kv_cache_dtype: an explicit int8 on either surface wins, and both
        # end up agreeing (as in the JAX package)
        if config.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"unknown kv_cache_dtype {config.kv_cache_dtype!r}; "
                "expected 'bf16' or 'int8'")
        kv_dtype = config.kv_cache_dtype
        if kv_dtype == "bf16" and rcfg.kv_cache_dtype != "bf16":
            kv_dtype = rcfg.kv_cache_dtype
        if kv_dtype != rcfg.kv_cache_dtype:
            rcfg = dataclasses.replace(rcfg, kv_cache_dtype=kv_dtype)
        if kv_dtype != config.kv_cache_dtype:
            self.config = config = config.replace(kv_cache_dtype=kv_dtype)
        self.device = resolve_device(device, "ServingEngine")
        self.cfg = cfg
        self.rcfg = rcfg
        self.model = get_model(cfg)
        self.kv_layout = kv_layout
        self.params = params
        self.max_batch = max_batch = config.max_batch
        self.max_seq = max_seq = config.max_seq
        self.prompt_buckets = tuple(sorted(
            {b for b in config.prompt_buckets if b < max_seq} | {max_seq}))
        self.clock = clock
        self.step_cost_fn = step_cost_fn
        self.variant_name = "bf16"
        self.swap_count = 0
        if kv_layout == "paged":
            self._init_paged(config)
        else:
            self.cache = init_params(
                self.model.cache_spec(rcfg, max_batch, max_seq), None,
                self.device)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # the admitted token row + emitted-count baseline per slot: together
        # they reconstruct the exact KV sequence when a slot is preempted
        self._slot_row: List[Optional[np.ndarray]] = [None] * max_batch
        self._slot_emit0 = [0] * max_batch
        self.scheduler = Scheduler()
        self._admit_seq = 0
        self._rid_counter = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # speculative decoding: the draft tree arrives via `set_draft_params`;
        # until then, and whenever k == 0, steps take the plain decode path.
        # Draft KV lives in leased scratch blocks, one lease list per slot:
        # the canonical block tables only ever hold verify-variant KV.
        sd = config.spec_decode
        self.spec_k = sd.k if sd is not None else 0
        self.draft_params = None
        self.draft_variant = sd.draft_variant if sd is not None else ""
        self._spec_leases: List[List[int]] = [[] for _ in range(max_batch)]
        self._prefer_prefill = True      # alternation flag: prefill <-> decode
        self._chunk_slots: set = set()   # dense: slots reserved by parked chunks
        # telemetry
        self.tokens_emitted = 0
        self.prefill_tokens_total = 0
        self.prefill_tokens_saved = 0
        self.peak_active = 0
        self.draft_tokens = 0            # drafted this engine's lifetime
        self.accepted_tokens = 0         # drafts that entered an output
        # decode steps whose paged-attention reads ran the plain version (a
        # CPU paged engine); a pure function of the device, counted per step
        self._paged_fallback = (kv_layout == "paged"
                                and paged_attention_uses_fallback(self.device))
        self.kernel_fallbacks = 0
        self.step_log: List[Dict] = []

    def _init_paged(self, config: EngineConfig):
        """The block pool, its refcounts, the prefix cache and the per-slot
        block tables of the paged layout."""
        cfg, max_batch = self.cfg, self.max_batch
        self.block_size = block_size = config.block_size
        # a CPU engine reads its pool through the plain version, which takes
        # any block size; the kernel's limits are checked here, not at the
        # first decode step
        if not paged_attention_uses_fallback(self.device):
            check_paged_kernel(cfg, block_size)
        self.blocks_per_slot = -(-self.max_seq // block_size)
        num_blocks = config.num_blocks
        if num_blocks is None:
            # all slots full + one transient CoW block per slot + one slot's
            # worth of slack for cached prefixes + scratch block 0
            num_blocks = ((max_batch + 1) * self.blocks_per_slot
                          + max_batch + 2)
            if self.rcfg.kv_cache_dtype == "int8":
                # same byte budget as the bf16 default pool, ~2x the blocks
                budget = (num_blocks - 1) * paged_block_bytes(
                    cfg, block_size, "bf16")
                num_blocks = 1 + budget // paged_block_bytes(
                    cfg, block_size, "int8")
        pool_spec = self.model.paged_cache_spec(self.rcfg, num_blocks,
                                                block_size)
        self.pool = init_params(pool_spec, None, self.device)
        self.block_pool = BlockPool(num_blocks, block_size)
        self.prefix_cache = PrefixCache(self.block_pool)
        self.block_tables = np.zeros((max_batch, self.blocks_per_slot),
                                     np.int32)
        self.slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
        self.cow_count = 0

    # -- public API ---------------------------------------------------------

    def swap_params(self, params, variant_name: str):
        """Hot-swap the weight tree (CarbonCall Q8<->Q4 switch). Parked
        partial prefills are dropped (their KV was computed under the old
        weights) and an in-flight draft's leases go back to the pool."""
        self.params = params
        self.variant_name = variant_name
        self.swap_count += 1
        for req in self.scheduler.waiting:
            if req.chunk_row is not None:
                self._release_chunk(req)
        for i in range(self.max_batch):
            self._spec_release_leases(i)

    def set_draft_params(self, params, variant_name: str):
        """Install the draft variant's weight tree (normally the executor's
        pre-quantized Q4 tree). Spec steps stay off until this is set, and
        stand down whenever the draft and resident variants coincide."""
        if self.config.spec_decode is None:
            raise ValueError(
                "set_draft_params: engine was built without spec_decode")
        self.draft_params = params
        self.draft_variant = variant_name

    def set_draft_k(self, k: int):
        """Set the draft length (the governor's carbon-modulated knob);
        k = 0 degrades to plain decode."""
        if k < 0:
            raise ValueError(f"set_draft_k: k must be >= 0, got {k}")
        self.spec_k = int(k)

    def submit(self, req: Request) -> RequestHandle:
        """Queue a request; returns an async handle (poll/result/cancel)."""
        self.scheduler.enqueue(req, self.clock())
        return RequestHandle(self, req)

    def client(self) -> "EngineClient":
        return EngineClient(self)

    def next_rid(self) -> int:
        self._rid_counter += 1
        return self._rid_counter - 1

    def cancel(self, req: Request) -> bool:
        """Cancel a waiting or running request, freeing its slot and blocks.
        False if it already reached a terminal state."""
        if req.status in TERMINAL:
            return False
        if req.status == WAITING:
            self.scheduler.remove(req)
            self._release_chunk(req)
        elif req in self.slots:
            self._free_slot(self.slots.index(req))
        req.status = CANCELLED
        req.resume_row = None
        self.scheduler.note_cancelled(req)
        return True

    @property
    def pending(self) -> List[Request]:
        return self.scheduler.waiting

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_work(self) -> bool:
        return self.active > 0 or self.scheduler.has_waiting()

    def scheduler_stats(self) -> Dict[str, float]:
        stats = self.scheduler.stats()
        stats["peak_active"] = self.peak_active
        return stats

    def prefix_cache_stats(self) -> Dict[str, int]:
        if self.kv_layout != "paged":
            return {}
        return {"hits": self.prefix_cache.hits,
                "misses": self.prefix_cache.misses,
                "entries": len(self.prefix_cache.entries),
                "cow": self.cow_count,
                "free_blocks": self.block_pool.num_free,
                "prefill_tokens_total": self.prefill_tokens_total,
                "prefill_tokens_saved": self.prefill_tokens_saved}

    def stats(self) -> EngineStats:
        return EngineStats.from_engine(self)

    def step(self) -> List[Request]:
        """Admit waiting requests into free slots (one batched prefill, one
        preemption-resume re-prefill, or, with `prefill_chunk`, one prefill
        window) or run one batched decode step (speculative when armed).
        With chunking the step alternates pending prefill work with a decode
        step for the residents. Returns requests completed this step."""
        t0 = self.clock()
        resident_rids = [s.rid for s in self.slots if s is not None]
        for req in self.scheduler.expire_due(t0):
            self._release_chunk(req)
        completed: List[Request] = []
        work: Optional[Dict] = None
        spec: Optional[Dict] = None
        if self.prefill_chunk is None or self._prefer_prefill \
                or not self.active:
            work = self._prefill_work()
        if work is None and not self.active \
                and self.prefill_chunk is not None:
            # liveness fallback: the head is blocked and nothing can decode,
            # so advance the first other parked chunk
            head = self.scheduler.head()
            for req in self.scheduler.waiting:
                if req is not head and req.chunk_row is not None:
                    work = self._chunk_step(req, self._free_slots())
                    if work is not None:
                        break
        if work is not None:
            kind = work["kind"]
            tokens_this_step = work["tokens"]
            charged, cached = work["charged"], work["cached"]
            rids = work["rids"]
            occupancy = max(self.active, 1)
            self._prefer_prefill = False
        elif self.active:
            charged = cached = 0
            # None falls back to plain decode (pool pressure, a row too near
            # max_seq): spec never preempts
            spec = self._spec_step(completed) if self._spec_ready() else None
            if spec is not None:
                tokens_this_step, rids = spec["tokens"], spec["rids"]
                kind = "spec_verify"
            else:
                tokens_this_step, rids = self._decode_active(completed)
                kind = "decode"
            occupancy = max(len(rids), 1)
            self._prefer_prefill = True
            if self._paged_fallback:
                self.kernel_fallbacks += 1
        else:
            if self.scheduler.has_waiting():
                raise PoolExhaustedError(
                    "paged KV pool exhausted: cannot admit any pending "
                    "request with an idle engine — raise num_blocks",
                    waiting=len(self.pending),
                    free_blocks=(self.block_pool.num_free
                                 if self.kv_layout == "paged" else 0))
            return completed
        self.peak_active = max(self.peak_active, self.active, occupancy)
        if self.step_cost_fn is not None and hasattr(self.clock, "advance"):
            if kind == "spec_verify":
                # the k draft rounds at the draft variant's power point, the
                # one batched verify at the resident variant's
                cost = (float(self.step_cost_fn(
                            "spec_draft", spec["drafted"], occupancy))
                        + float(self.step_cost_fn(
                            "spec_verify", spec["verified"], occupancy)))
            else:
                cost_tokens = charged if kind != "decode" else tokens_this_step
                cost = float(self.step_cost_fn(kind, cost_tokens, occupancy))
            if cost > 0.0:
                self.clock.advance(cost)
        for req in completed:                # completion is at end of step
            req.done_time = self.clock()
            self.scheduler.note_done(req, req.done_time)
        dt = max(self.clock() - t0, 1e-9)
        self.tokens_emitted += tokens_this_step
        rec = {
            "kind": kind, "tokens": tokens_this_step, "dt": dt,
            "tps": tokens_this_step / dt, "variant": self.variant_name,
            "active": occupancy, "prompt_tokens": charged,
            "cached_tokens": cached, "rids": rids,
            "resident_rids": resident_rids}
        if spec is not None:
            # spec rows emit per-rid token counts: `emitted`
            rec["drafted"] = spec["drafted"]
            rec["accepted"] = spec["accepted"]
            rec["emitted"] = spec["emitted"]
        self.step_log.append(rec)
        return completed

    def run_until_drained(self, max_steps: int = 100000) -> List[Request]:
        done = []
        for _ in range(max_steps):
            if not self.has_work():
                return done
            done.extend(self.step())
        if self.has_work():
            raise EngineStallError(
                f"engine not drained after {max_steps} steps "
                f"(active={self.active}, waiting={len(self.pending)})")
        return done

    # -- admission ----------------------------------------------------------

    def _free_slots(self) -> List[int]:
        """Slots open to an admission: empty and not reserved by a parked
        dense chunk."""
        return [i for i, s in enumerate(self.slots)
                if s is None and i not in self._chunk_slots]

    def _prefill_work(self) -> Optional[Dict]:
        """One unit of pending prefill work for the queue head — a resume
        re-prefill or a batched fresh admission — as its step-log record, or
        None when nothing can run (the step decodes instead)."""
        head = self.scheduler.head()
        if head is None:
            return None
        free = self._free_slots()
        if head.resume_row is not None:
            # strict priority: a blocked resume never lets lower-priority
            # fresh admissions jump it — decode continues instead
            if not free:
                return None
            got = self._try_resume(head, free[0])
            if got < 0:
                return None
            return {"kind": "prefill", "tokens": 0, "charged": got,
                    "cached": 0, "rids": [head.rid]}
        if self._chunk_needed(head):
            return self._chunk_step(head, free)
        if not free:
            return None
        admitted, charged, cached = self._admit_batch(free)
        if not admitted:
            return None
        return {"kind": "prefill", "tokens": len(admitted),
                "charged": charged, "cached": cached,
                "rids": [r.rid for r in admitted]}

    def _place(self, req: Request, slot: int, row: np.ndarray):
        """Common slot bookkeeping at (re)admission."""
        self.slots[slot] = req
        self._slot_row[slot] = np.asarray(row, np.int32)
        req.status = RUNNING
        req.admit_seq = self._admit_seq
        self._admit_seq += 1

    def _admit_batch(self, free: List[int]):
        """Batched admission: fill free slots this step. Returns (admitted
        requests, prompt tokens charged, prompt tokens cached)."""
        if self.kv_layout == "paged":
            return self._admit_batch_paged(free)
        reqs: List[Request] = []
        for req in self.scheduler.waiting:
            if self._chunk_needed(req):
                break               # chunked admissions run one window a step
            reqs.append(req)
            if len(reqs) == len(free):
                break
        if not reqs:
            return [], 0, 0
        now = self.clock()
        for req in reqs:
            self.scheduler.note_admitted(req, now)
        b = _bucket(max(len(r.prompt) for r in reqs), self.prompt_buckets)
        toks = np.zeros((self.max_batch, b), np.int32)
        for i, r in enumerate(reqs):
            toks[i] = self._padded_row(r.prompt, b)
        logits, entry, lengths_n = self.model.prefill(
            self.params, self._batch(toks), self.rcfg)
        lengths_n = lengths_n.cpu().numpy()
        for i, (req, slot) in enumerate(zip(reqs, free)):
            for key, leaf in self.cache.items():
                self._write_slot(leaf[:, slot], entry[key][:, i])
            self.lengths[slot] = int(lengths_n[i])
            self._place(req, slot, toks[i])
            tok = self._sample(logits[i:i + 1], req)
            self._emit(req, slot, int(tok[0]))
            self._slot_emit0[slot] = len(req.output)
        return reqs, sum(len(r.prompt) for r in reqs), 0

    @staticmethod
    def _write_slot(dst, src):
        """Copy one row's cache leaf into its slot: whole for a state
        (mamba2), or the S prefilled positions at the head of a (max_seq,
        ...) KV stripe with zeros after them, as the JAX package's padded
        prefill cache leaves it."""
        if src.shape == dst.shape:
            dst.copy_(src)
            return
        S = src.shape[1]
        dst[:, :S] = src.to(dst.dtype)
        dst[:, S:] = 0

    def _admit_batch_paged(self, free: List[int]):
        """Paged admission: look up each prompt's longest cached prefix chain,
        share those blocks (copy-on-write protected), allocate fresh blocks
        for the rest, and prefill only the non-cached suffixes. Watermark
        accounting: an admission needs its fresh prompt blocks plus one
        growth block per resident slot; over-commitment is resolved later by
        preemption. Returns (admitted, prompt tokens charged, cached)."""
        bs = self.block_size
        cand: List[Request] = []
        for req in self.scheduler.waiting:
            if req.resume_row is not None or self._chunk_needed(req):
                break               # resumes and chunked prefills advance
                                    # one per step
            cand.append(req)
            if len(cand) == len(free):
                break
        if not cand:
            return [], 0, 0
        b = _bucket(max(len(r.prompt) for r in cand), self.prompt_buckets)
        nb_prompt = -(-b // bs)
        rows = []
        for pos, req in enumerate(cand):
            row = self._padded_row(req.prompt, b)
            hit = self.prefix_cache.lookup(row, salt=self.variant_name)
            cached_len = hit.cached_len if hit else 0
            cached_blocks = list(hit.blocks) if hit else []
            if hit and cached_len == b and hit.last_logits is None:
                # whole-row match against an interior boundary of a longer
                # cached row: no stored logits, so recompute the last stripe
                cached_len -= bs if b % bs == 0 else b % bs
                cached_blocks = cached_blocks[:-1]
            # hold refs on the cached chain BEFORE allocating: eviction under
            # pressure must not free blocks this admission is about to share
            for bid in cached_blocks:
                self.block_pool.incref(bid)
            n_fresh = nb_prompt - len(cached_blocks)
            headroom = self.active + len(rows) + 1
            preempted_before = self.scheduler.preemptions
            ok = self._reclaim(n_fresh + headroom,
                               priority=req.priority if pos == 0 else None)
            fresh = self._alloc_blocks(n_fresh) if ok else None
            if fresh is None:
                for bid in cached_blocks:
                    self.block_pool.decref(bid)
                break
            self.scheduler.note_admitted(req, self.clock())
            rows.append({"req": req, "row": row, "hit": hit,
                         "cached_len": cached_len,
                         "blocks": cached_blocks + fresh})
            if cached_len > 0:
                self.prefix_cache.hits += 1
            else:
                self.prefix_cache.misses += 1
            if self.scheduler.preemptions > preempted_before:
                # the head preempted a victim to get in: stop the batch so
                # the requeued victim is reconsidered first
                break
        if not rows:
            return [], 0, 0

        full = [r for r in rows if r["cached_len"] == b]
        compute = [r for r in rows if r["cached_len"] < b]
        if compute:
            if all(r["cached_len"] == 0 for r in compute):
                logits_c = self._prefill_cold(compute, b)
            else:
                logits_c = self._prefill_suffix(compute, b)
            for i, r in enumerate(compute):
                r["logits"] = logits_c[i].clone()
                self.prefix_cache.insert(r["row"], r["blocks"],
                                         last_logits=r["logits"],
                                         salt=self.variant_name)
        for r in full:
            r["logits"] = r["hit"].last_logits

        charged = cached = 0
        for r, slot in zip(rows, free):
            req = r["req"]
            pad = b - min(len(req.prompt), b)
            cached_real = max(0, r["cached_len"] - pad)
            charged += max(0, len(req.prompt) - cached_real)
            cached += cached_real
            self.slot_blocks[slot] = list(r["blocks"])
            self.block_tables[slot] = 0
            self.block_tables[slot, :len(r["blocks"])] = r["blocks"]
            self.lengths[slot] = b
            self._place(req, slot, r["row"])
            tok = self._sample(r["logits"][None, :], req)
            self._emit(req, slot, int(tok[0]))
            self._slot_emit0[slot] = len(req.output)
        self.prefill_tokens_total += charged + cached
        self.prefill_tokens_saved += cached
        return [r["req"] for r in rows], charged, cached

    # -- chunked prefill -----------------------------------------------------

    def _chunk_needed(self, req: Request) -> bool:
        """Whether `req` admits through the chunked path: chunking enabled,
        and the prompt's non-cached prefill work exceeds one window."""
        if self.prefill_chunk is None or req.resume_row is not None:
            return False
        if req.chunk_row is not None:
            return True                  # mid-chunk: must finish via chunks
        b = _bucket(len(req.prompt), self.prompt_buckets)
        if b <= self.prefill_chunk:
            return False
        if self.kv_layout != "paged":
            return True
        row = self._padded_row(req.prompt, b)
        hit = self.prefix_cache.lookup(row, salt=self.variant_name)
        cached = hit.cached_len if hit else 0
        if cached >= b:
            return False                 # whole-row hit: one cheap admission
        return b - cached > self.prefill_chunk

    def _chunk_init(self, req: Request):
        """First window of a chunked prefill: bucket the prompt and (paged)
        adopt the longest cached prefix chain, one ref per block (as an
        admission), so eviction cannot free the chain while it is
        extended."""
        b = _bucket(len(req.prompt), self.prompt_buckets)
        row = self._padded_row(req.prompt, b)
        cached_len = 0
        hit = None
        if self.kv_layout == "paged":
            hit = self.prefix_cache.lookup(row, salt=self.variant_name)
        if hit is not None:
            cached_len = hit.cached_len
            for bid in hit.blocks:
                self.block_pool.incref(bid)
            req.chunk_blocks = list(hit.blocks)
        pad = b - min(len(req.prompt), b)
        req.chunk_row = row
        req.chunk_done = cached_len
        req.chunk_cached = max(0, cached_len - pad)
        req.chunk_hit = cached_len > 0

    def _chunk_window(self, req: Request, start: int, end: int,
                      final: bool):
        """Run the prefill window [start, end) of the parked chain and write
        its KV into the chain's blocks. Returns the last-position logits
        (only when `final`)."""
        bs = self.block_size
        row = req.chunk_row
        nwin = end - start
        if start == 0:
            # cold first window (never final: `_chunk_needed` guarantees it
            # cannot cover the whole bucket): the stock prefill over a
            # right-padded pow2 row, positions [0, end) scattered
            W = _pow2(end, self.max_seq)
            toks = np.zeros((self.max_batch, W), np.int32)
            toks[0, :end] = row[:end]
            _, entry, _ = self.model.prefill(self.params, self._batch(toks),
                                             self.rcfg)
            dst = [req.chunk_blocks[p // bs] * bs + p % bs
                   for p in range(end)]
            self._scatter(entry, dst, [0] * end, list(range(end)))
            return None
        # later windows: the parked chain is the cached prefix and the window
        # a left-padded suffix at its exact absolute positions, rounded as a
        # prefix-cache hit's admission is
        W = _pow2(nwin, len(row))
        nbp = _pow2(-(-start // bs), self.blocks_per_slot)
        toks = np.zeros((self.max_batch, W), np.int32)
        toks[0, W - nwin:] = row[start:end]
        bids = np.zeros((self.max_batch, nbp), np.int32)
        bids[0, :start // bs] = req.chunk_blocks[:start // bs]
        plens = np.zeros((self.max_batch,), np.int32)
        plens[0] = start
        batch = self._batch(toks)
        batch["positions"] = torch.arange(end - W, end, dtype=torch.int32,
                                          device=self.device)
        k_pre, v_pre = self._gather_prefix(bids)
        logits, (k_win, v_win) = self.model.prefill_chunk(
            self.params, batch, k_pre, v_pre,
            torch.as_tensor(plens, device=self.device), self.rcfg,
            need_logits=final)
        dst = [req.chunk_blocks[p // bs] * bs + p % bs
               for p in range(start, end)]
        src_s = [p - (end - W) for p in range(start, end)]
        entry = quantize_kv_for_cache("k_scale" in self.pool, k_win, v_win)
        self._scatter(entry, dst, [0] * nwin, src_s)
        return logits

    def _chunk_step(self, req: Request, free: List[int]) -> Optional[Dict]:
        """Advance `req`'s chunked prefill by one window. Returns the
        step-log record, or None when the window cannot run yet."""
        if self.kv_layout == "paged":
            return self._chunk_step_paged(req, free)
        return self._chunk_step_dense(req, free)

    def _chunk_step_paged(self, req: Request,
                          free: List[int]) -> Optional[Dict]:
        bs = self.block_size
        if req.chunk_row is None:
            self._chunk_init(req)
        row = req.chunk_row
        b = len(row)
        start = req.chunk_done
        end = min(start + self.prefill_chunk, b)
        final = end >= b
        if final and not free:
            return None                  # the final window needs a slot
        need = -(-end // bs) - len(req.chunk_blocks)
        if need > 0:
            if not self._reclaim(need + self.active + 1,
                                 priority=req.priority, exclude=req):
                return None              # parked state persists; retry later
            fresh = self._alloc_blocks(need)
            if fresh is None:            # unreachable after _reclaim
                return None
            req.chunk_blocks.extend(fresh)
        logits = self._chunk_window(req, start, end, final)
        req.chunk_done = end
        pad = b - min(len(req.prompt), b)
        charged = max(0, end - max(start, pad))
        self.prefill_tokens_total += charged
        if not final:
            # park the progress as ordinary prefix-cache entries: pinned by
            # the request's refs while it extends them, shareable by
            # admissions of the same prefix, evictable once dropped
            self.prefix_cache.insert(row[:end], req.chunk_blocks,
                                     salt=self.variant_name)
            self.scheduler.note_chunk_step(req)
            return {"kind": "prefill_chunk", "tokens": 0, "charged": charged,
                    "cached": 0, "rids": [req.rid]}
        # final window: admit into the slot as a batched admission does
        charged += max(0, len(req.prompt) - b)   # no free truncation discount
        slot = free[0]
        self.scheduler.note_admitted(req, self.clock())
        last = logits[0].clone()
        self.prefix_cache.insert(row, req.chunk_blocks, last_logits=last,
                                 salt=self.variant_name)
        if req.chunk_hit:
            self.prefix_cache.hits += 1
        else:
            self.prefix_cache.misses += 1
        cached = req.chunk_cached
        self.prefill_tokens_total += cached
        self.prefill_tokens_saved += cached
        self.slot_blocks[slot] = list(req.chunk_blocks)   # refs transfer
        self.block_tables[slot] = 0
        self.block_tables[slot, :len(req.chunk_blocks)] = req.chunk_blocks
        self.lengths[slot] = b
        self._place(req, slot, row)
        tok = self._sample(last[None, :], req)
        self._emit(req, slot, int(tok[0]))
        self._slot_emit0[slot] = len(req.output)
        self._clear_chunk(req)
        return {"kind": "prefill", "tokens": 1, "charged": charged,
                "cached": cached, "rids": [req.rid]}

    def _chunk_step_dense(self, req: Request,
                          free: List[int]) -> Optional[Dict]:
        """One window into the slot stripe the request reserves at its first
        window; the final window admits it in that slot."""
        if req.chunk_row is None:
            if not free:
                return None              # needs a slot stripe to reserve
            self._chunk_init(req)
            req.chunk_slot = free[0]
            self._chunk_slots.add(free[0])
        slot = req.chunk_slot
        row = req.chunk_row
        b = len(row)
        start = req.chunk_done
        end = min(start + self.prefill_chunk, b)
        final = end >= b
        nwin = end - start
        logits = None
        if start == 0:
            # cold first window (never final, see _chunk_window): the stock
            # prefill over [0, end), its KV copied into the reserved stripe
            W = _pow2(end, self.max_seq)
            toks = np.zeros((self.max_batch, W), np.int32)
            toks[0, :end] = row[:end]
            _, entry, _ = self.model.prefill(self.params, self._batch(toks),
                                             self.rcfg)
            for key, leaf in self.cache.items():
                leaf[:, slot, :end] = entry[key][:, 0, :end].to(leaf.dtype)
        else:
            # the prefix view is cache[:, :, :p_len] over every slot, so the
            # window rides in batch row `slot` to attend the reserved stripe
            p_len = _pow2(start, self.max_seq)
            W = _pow2(nwin, b)
            toks = np.zeros((self.max_batch, W), np.int32)
            toks[slot, W - nwin:] = row[start:end]
            plens = np.zeros((self.max_batch,), np.int32)
            plens[slot] = start
            batch = self._batch(toks)
            batch["positions"] = torch.arange(end - W, end, dtype=torch.int32,
                                              device=self.device)
            # the JAX package's `prefill_dense_chunk_impl`: the first p_len
            # positions of every stripe, dequantized
            k_pre, v_pre = dequant_cache({key: leaf[:, :, :p_len]
                                          for key, leaf in self.cache.items()})
            logits, (k_win, v_win) = self.model.prefill_chunk(
                self.params, batch, k_pre, v_pre,
                torch.as_tensor(plens, device=self.device), self.rcfg,
                need_logits=final)
            entry = quantize_kv_for_cache("k_scale" in self.cache, k_win,
                                          v_win)
            for key, leaf in self.cache.items():
                leaf[:, slot, start:end] = entry[key][:, slot, W - nwin:].to(
                    leaf.dtype)
        req.chunk_done = end
        # the stripe's fill mark moves to the next window's first position:
        # a dense decode step writes its KV at lengths[i] for every row, this
        # stripe's too, and the next window overwrites that position
        self.lengths[slot] = end
        pad = b - min(len(req.prompt), b)
        charged = max(0, end - max(start, pad))
        if not final:
            self.scheduler.note_chunk_step(req)
            return {"kind": "prefill_chunk", "tokens": 0, "charged": charged,
                    "cached": 0, "rids": [req.rid]}
        charged += max(0, len(req.prompt) - b)   # no free truncation discount
        self.scheduler.note_admitted(req, self.clock())
        self._chunk_slots.discard(slot)
        self._place(req, slot, row)
        tok = self._sample(logits[slot:slot + 1], req)
        self._emit(req, slot, int(tok[0]))
        self._slot_emit0[slot] = len(req.output)
        self._clear_chunk(req)
        return {"kind": "prefill", "tokens": 1, "charged": charged,
                "cached": 0, "rids": [req.rid]}

    def _clear_chunk(self, req: Request):
        req.chunk_row = None
        req.chunk_done = 0
        req.chunk_blocks = []
        req.chunk_cached = 0
        req.chunk_hit = False
        req.chunk_slot = None

    def _release_chunk(self, req: Request):
        """Drop a parked partial prefill (cancel, expiry, hot swap, pool
        pressure). Paged: the request's block refs go, and its progress
        survives as ordinary prefix-cache entries until eviction needs the
        blocks. Dense: the reserved slot stripe is returned."""
        if req.chunk_row is None:
            return
        if self.kv_layout == "paged":
            for bid in req.chunk_blocks:
                self.block_pool.decref(bid)
        elif req.chunk_slot is not None:
            self._chunk_slots.discard(req.chunk_slot)
            self.lengths[req.chunk_slot] = 0
        self._clear_chunk(req)
        self.scheduler.note_chunk_dropped(req)

    def _drop_parked_chunk(self, exclude: Optional[Request]) -> bool:
        """Release the lowest-priority (newest on ties) parked partial
        prefill other than `exclude`'s to relieve block pressure. The
        request stays queued."""
        cands = [r for r in self.scheduler.waiting
                 if r.chunk_row is not None and r is not exclude]
        if not cands:
            return False
        self._release_chunk(min(cands, key=lambda r: (r.priority, -r.seq)))
        return True

    # -- preemption / resume -------------------------------------------------

    def _reclaim(self, want_free: int, *, priority: Optional[int],
                 exclude: Optional[Request] = None) -> bool:
        """Bring the pool's free count up to `want_free`: first by LRU
        prefix-cache eviction, then by dropping another waiting request's
        parked partial prefill, then (when `priority` is given) by preempting
        strictly-lower-priority running slots on the caller's behalf.
        `exclude` protects the caller's own parked chain."""
        while self.block_pool.num_free < want_free:
            if self.prefix_cache.evict_lru():
                continue
            if self._drop_parked_chunk(exclude):
                continue
            victim = None
            if priority is not None:
                victim = Scheduler.pick_victim(
                    [(s, r) for s, r in enumerate(self.slots)
                     if r is not None], below=priority)
            if victim is None:
                return False
            self._preempt_slot(victim)
        return True

    def _preempt_slot(self, i: int):
        """Evict slot `i`: save the exact token sequence its KV covers, free
        its blocks, and put it back at the front of its priority class."""
        req = self.slots[i]
        e = self._slot_emit0[i]
        seq = np.concatenate([
            self._slot_row[i],
            np.asarray(req.output[e - 1:len(req.output) - 1], np.int32)])
        req.resume_row = seq[:int(self.lengths[i])]
        self._free_slot(i)
        self.scheduler.note_preempted(req)
        self.scheduler.requeue(req, self.clock())

    def _try_resume(self, req: Request, slot: int) -> int:
        """Re-admit a preempted request: re-prefill its saved sequence at
        the exact original positions (right-padded to a power-of-two width;
        causal attention never sees the padding). Returns the recomputed
        token count, or -1 if blocks are still unavailable."""
        bs = self.block_size
        row = req.resume_row
        L = len(row)
        nb = -(-L // bs)
        if not self._reclaim(nb + self.active + 1, priority=req.priority):
            return -1
        blocks = self._alloc_blocks(nb)
        if blocks is None:                   # unreachable after _reclaim
            return -1
        W = _pow2(L, self.max_seq)
        toks = np.zeros((self.max_batch, W), np.int32)
        toks[0, :L] = row
        _, entry, _ = self.model.prefill(self.params, self._batch(toks),
                                         self.rcfg)
        dst = [blocks[p // bs] * bs + p % bs for p in range(L)]
        self._scatter(entry, dst, [0] * L, list(range(L)))
        self.slot_blocks[slot] = list(blocks)
        self.block_tables[slot] = 0
        self.block_tables[slot, :nb] = blocks
        self.lengths[slot] = L
        self._place(req, slot, row)
        self._slot_emit0[slot] = len(req.output)
        req.resume_row = None
        self.scheduler.note_admitted(req, self.clock())
        return L

    def _decode_alloc(self, i: int) -> Optional[int]:
        """Allocate one block for decoding slot `i` under pool pressure:
        evict cached prefixes, then preempt the lowest-priority slot. None
        when slot `i` preempted itself; raises when a single resident
        sequence cannot fit the pool."""
        while True:
            bid = self.block_pool.alloc()
            if bid is not None:
                return bid
            if self.prefix_cache.evict_lru():
                continue
            if self._drop_parked_chunk(None):
                continue                 # parked chains yield before slots do
            active = [(s, r) for s, r in enumerate(self.slots)
                      if r is not None]
            if len(active) <= 1:
                raise PoolExhaustedError(
                    "paged KV pool exhausted mid-decode with no preemptable "
                    "slot — raise num_blocks",
                    waiting=len(self.pending),
                    free_blocks=self.block_pool.num_free)
            victim = Scheduler.pick_victim(active)
            self._preempt_slot(victim)
            if victim == i:
                return None

    # -- device-side KV movement ----------------------------------------------

    def _batch(self, tokens: np.ndarray) -> Dict[str, torch.Tensor]:
        return {"tokens": torch.as_tensor(tokens, device=self.device)}

    def _scatter(self, entry, dst, src_b, src_s):
        """Write entry[key][:, src_b[i], src_s[i]] into flat pool position
        dst[i] (= block_id * block_size + offset) for every i, per leaf."""
        dev = self.device
        dst_t = torch.as_tensor(dst, dtype=torch.long, device=dev)
        b_t = torch.as_tensor(src_b, dtype=torch.long, device=dev)
        s_t = torch.as_tensor(src_s, dtype=torch.long, device=dev)
        for key, leaf in self.pool.items():
            flat = leaf.view(leaf.shape[0], leaf.shape[1] * leaf.shape[2],
                             *leaf.shape[3:])
            flat[:, dst_t] = entry[key][:, b_t, s_t].to(leaf.dtype)

    def _copy_block(self, dst: int, src: int):
        for leaf in self.pool.values():
            leaf[:, dst] = leaf[:, src]

    def _gather_prefix(self, prefix_bids: np.ndarray):
        """Cached prefix blocks as a dense per-row (k, v) view, bf16."""
        bids = torch.as_tensor(prefix_bids, dtype=torch.long,
                               device=self.device)
        nbp = bids.shape[1]

        def view(key):
            g = self.pool[key][:, bids]          # (L, B, nbp, bs, ...)
            return g.reshape(g.shape[0], g.shape[1], nbp * self.block_size,
                             *g.shape[4:])

        return dequant_cache({key: view(key) for key in self.pool})

    def _prefill_cold(self, compute, b: int):
        """No cached prefix anywhere in the batch: run the stock full-row
        prefill and scatter every position into the rows' blocks."""
        toks = np.zeros((self.max_batch, b), np.int32)
        for i, r in enumerate(compute):
            toks[i] = r["row"]
        logits, entry, _ = self.model.prefill(self.params, self._batch(toks),
                                              self.rcfg)
        dst, src_b, src_s = [], [], []
        for i, r in enumerate(compute):
            for p in range(b):
                dst.append(r["blocks"][p // self.block_size]
                           * self.block_size + p % self.block_size)
                src_b.append(i)
                src_s.append(p)
        self._scatter(entry, dst, src_b, src_s)
        return logits

    def _prefill_suffix(self, compute, b: int):
        """At least one row has a cached prefix: gather the prefix KV views
        and run the model over the suffixes only (suffix width and prefix
        block count rounded up to powers of two, as in the JAX package)."""
        bs = self.block_size
        s_suf = _pow2(b - min(r["cached_len"] for r in compute), b)
        p_len = max(r["cached_len"] for r in compute)
        nbp = _pow2(-(-p_len // bs), self.blocks_per_slot)
        toks = np.zeros((self.max_batch, s_suf), np.int32)
        bids = np.zeros((self.max_batch, nbp), np.int32)
        plens = np.zeros((self.max_batch,), np.int32)
        for i, r in enumerate(compute):
            cl = r["cached_len"]
            suf = r["row"][cl:]
            toks[i, s_suf - len(suf):] = suf
            bids[i, :cl // bs] = r["blocks"][:cl // bs]
            plens[i] = cl
        batch = self._batch(toks)
        batch["positions"] = torch.arange(b - s_suf, b, dtype=torch.int32,
                                          device=self.device)
        k_pre, v_pre = self._gather_prefix(bids)
        logits, (k_suf, v_suf) = self.model.prefill_paged(
            self.params, batch, k_pre, v_pre,
            torch.as_tensor(plens, device=self.device), self.rcfg)
        dst, src_b, src_s = [], [], []
        for i, r in enumerate(compute):
            for p in range(r["cached_len"], b):
                dst.append(r["blocks"][p // bs] * bs + p % bs)
                src_b.append(i)
                src_s.append(p - (b - s_suf))
        entry = quantize_kv_for_cache("k_scale" in self.pool, k_suf, v_suf)
        self._scatter(entry, dst, src_b, src_s)
        return logits

    def _padded_row(self, prompt: List[int], b: int) -> np.ndarray:
        p = prompt[-b:] if len(prompt) > b else \
            [0] * (b - len(prompt)) + list(prompt)
        return np.asarray(p, np.int32)

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Allocate n blocks, evicting LRU prefix-cache entries under
        pressure; None (nothing held) if the pool is truly exhausted."""
        got: List[int] = []
        while len(got) < n:
            bid = self.block_pool.alloc()
            if bid is not None:
                got.append(bid)
            elif not self.prefix_cache.evict_lru():
                for g in got:
                    self.block_pool.decref(g)
                return None
        return got

    # -- decode -------------------------------------------------------------

    def _decode_active(self, completed: List[Request]):
        """One batched decode step over the resident slots. Returns
        (tokens emitted, rids of the slots that actually decoded)."""
        last = np.zeros((self.max_batch, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is not None:
                last[i, 0] = req.output[-1] if req.output else (
                    req.prompt[-1] if req.prompt else 0)
        dev = self.device
        if self.kv_layout == "paged":
            self._prepare_decode_blocks()
            logits, self.pool = self.model.decode_step_paged(
                self.params, self.pool, torch.as_tensor(last, device=dev),
                torch.as_tensor(self.lengths, device=dev),
                torch.as_tensor(self.block_tables, device=dev), self.rcfg,
                seq_cap=self.max_seq)
        else:
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, torch.as_tensor(last, device=dev),
                torch.as_tensor(self.lengths, device=dev), self.rcfg)
        # saturate at max_seq: a full context drops further KV writes
        for i, req in enumerate(self.slots):
            if req is not None:
                self.lengths[i] = min(self.lengths[i] + 1, self.max_seq)
        emitted = 0
        rids: List[int] = []
        toks = None
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if toks is None:
                toks = self._sample(logits, req)
            tok = int(toks[i])
            self._emit(req, i, tok)
            emitted += 1
            rids.append(req.rid)
            if tok == req.eos_id or len(req.output) >= req.max_new_tokens:
                completed.append(req)        # done_time stamped at end of step
                req.status = DONE
                self._free_slot(i)
        return emitted, rids

    def _prepare_decode_blocks(self):
        """Host-side block management before a paged decode step: extend a
        slot's chain when its write position crosses a block boundary, and
        copy-on-write when it is about to write into a shared block."""
        bs = self.block_size
        for i, req in enumerate(self.slots):
            if req is None or self.slots[i] is None:
                continue                     # slot preempted earlier this step
            pos = int(self.lengths[i])
            if pos >= self.max_seq:
                continue                     # write is dropped by the model
            blk = pos // bs
            bid = int(self.block_tables[i, blk])
            if bid == 0:
                new = self._decode_alloc(i)
                if new is None:
                    continue                 # slot i preempted itself
                self.block_tables[i, blk] = new
                self.slot_blocks[i].append(new)
            elif self.block_pool.is_shared(bid):
                new = self._decode_alloc(i)
                if new is None:
                    continue
                self._copy_block(new, bid)
                self.block_pool.decref(bid)
                self.block_tables[i, blk] = new
                self.slot_blocks[i][blk] = new
                self.cow_count += 1

    # -- speculative decoding ------------------------------------------------

    def _spec_ready(self) -> bool:
        """Whether this step may draft: spec configured, draft weights
        installed, k > 0, the draft is not the resident variant, and every
        resident stream is greedy (acceptance compares argmaxes)."""
        if (self.config.spec_decode is None
                or self.spec_k <= 0 or self.draft_params is None
                or self.draft_variant == self.variant_name):
            return False
        return all(r is None or r.temperature <= 0.0 for r in self.slots)

    def _spec_reserve(self, n: int) -> bool:
        """Ensure >= n free blocks by prefix-cache eviction only: a spec step
        never preempts a slot or drops a parked chunk, it falls back."""
        while self.block_pool.num_free < n:
            if not self.prefix_cache.evict_lru():
                return False
        return True

    def _spec_acquire_leases(self, i: int, L: int, k: int) -> List[int]:
        """Lease scratch blocks covering draft positions [L, L+k-1] for slot
        `i`. When L sits mid-block the first lease starts as a copy of the
        canonical partial block, so drafts read the real prefix KV below L;
        the canonical block itself is never written by a draft."""
        bs = self.block_size
        blocks = [self.block_pool.alloc()
                  for _ in range(L // bs, (L + k - 1) // bs + 1)]
        assert all(b is not None for b in blocks), \
            "spec lease alloc failed despite reservation"
        self._spec_leases[i] = blocks
        if L % bs:
            src = int(self.block_tables[i, L // bs])
            if src:                      # always true for a live slot
                self._copy_block(blocks[0], src)
        return blocks

    def _spec_release_leases(self, i: int):
        """Return slot `i`'s draft scratch blocks to the pool (after the
        verify, and on cancel, expiry, preemption and hot swap)."""
        for bid in self._spec_leases[i]:
            self.block_pool.decref(bid)
        self._spec_leases[i] = []

    def _spec_step(self, completed: List[Request]) -> Optional[Dict]:
        """One speculative decode step over the resident slots: k greedy
        draft rounds under the draft variant (KV into leased scratch blocks),
        one batched verify forward under the resident variant over each
        row's k+1 window, then the longest agreeing draft prefix plus the
        verify token are emitted, their KV written into the canonical chain
        (allocating and copying on write as a decode step does) and the
        leases returned. None falls back to a plain decode step: the pool
        cannot reserve the worst case, or a row is within k+1 of max_seq."""
        bs, k = self.block_size, self.spec_k
        live = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        need = 0
        for i, _ in live:
            L = int(self.lengths[i])
            if L + k + 1 > self.max_seq:
                return None
            # the leases, one block per boundary the commit at [L, L+k]
            # crosses, and an alloc or copy for the write block itself
            need += (L + k - 1) // bs - L // bs + 1
            need += (L + k) // bs - L // bs
            bid = int(self.block_tables[i, L // bs])
            if bid == 0 or self.block_pool.is_shared(bid):
                need += 1
        if not self._spec_reserve(need):
            return None
        dev = self.device

        # -- draft: k greedy rounds under the draft variant ------------------
        last0 = np.zeros((self.max_batch, 1), np.int32)
        for i, r in live:
            last0[i, 0] = r.output[-1] if r.output else (
                r.prompt[-1] if r.prompt else 0)
        draft_tables = self.block_tables.copy()
        for i, _ in live:
            L = int(self.lengths[i])
            for j, bid in enumerate(self._spec_acquire_leases(i, L, k)):
                draft_tables[i, L // bs + j] = bid
        tables_t = torch.as_tensor(draft_tables, device=dev)
        draft_lengths = self.lengths.copy()
        draft_toks = np.zeros((self.max_batch, k), np.int32)
        cur = last0.copy()
        for j in range(k):
            logits, self.pool = self.model.decode_step_paged(
                self.draft_params, self.pool, torch.as_tensor(cur, device=dev),
                torch.as_tensor(draft_lengths, device=dev), tables_t,
                self.rcfg, seq_cap=self.max_seq)
            nxt = self._greedy(logits)
            for i, _ in live:
                draft_toks[i, j] = nxt[i]
                cur[i, 0] = nxt[i]
                draft_lengths[i] += 1

        # -- verify: one batched forward over the k+1 windows ----------------
        W = k + 1
        nbp = _pow2(max(-(-int(self.lengths[i]) // bs) for i, _ in live),
                    self.blocks_per_slot)
        toks = np.zeros((self.max_batch, W), np.int32)
        poss = np.zeros((self.max_batch, W), np.int32)
        bids = np.zeros((self.max_batch, nbp), np.int32)
        plens = np.zeros((self.max_batch,), np.int32)
        for i, _ in live:
            L = int(self.lengths[i])
            toks[i, 0] = last0[i, 0]
            toks[i, 1:] = draft_toks[i]
            poss[i] = np.arange(L, L + W)
            nb = -(-L // bs)
            bids[i, :nb] = self.block_tables[i, :nb]
            plens[i] = L
        batch = self._batch(toks)
        batch["positions"] = torch.as_tensor(poss, device=dev)
        k_pre, v_pre = self._gather_prefix(bids)
        logits, (k_win, v_win) = self.model.verify_paged(
            self.params, batch, k_pre, v_pre,
            torch.as_tensor(plens, device=dev), self.rcfg)
        greedy = self._greedy(logits)                       # (B, W)

        # -- accept, commit canonical KV, return the leases ------------------
        drafted = k * len(live)
        accepted = 0
        outs: List[List[int]] = []
        dst: List[int] = []
        src_b: List[int] = []
        src_s: List[int] = []
        for i, r in live:
            L = int(self.lengths[i])
            a = 0
            while a < k and draft_toks[i, a] == greedy[i, a]:
                a += 1
            toks_out: List[int] = []
            for j in range(a + 1):
                t = int(greedy[i, j])
                toks_out.append(t)
                if (t == r.eos_id
                        or len(r.output) + len(toks_out)
                        >= r.max_new_tokens):
                    break
            e = len(toks_out)
            accepted += min(e, a)        # the e-th token is the free verify
            outs.append(toks_out)
            # window position m holds the KV of position L+m; the last
            # emitted token's KV is not written, as in plain decode
            for p in range(L, L + e):
                blk = p // bs
                bid = int(self.block_tables[i, blk])
                if bid == 0:
                    new = self.block_pool.alloc()
                    assert new is not None, "spec commit alloc underflowed"
                    self.block_tables[i, blk] = new
                    self.slot_blocks[i].append(new)
                    bid = new
                elif self.block_pool.is_shared(bid):
                    new = self.block_pool.alloc()
                    assert new is not None, "spec CoW alloc underflowed"
                    self._copy_block(new, bid)
                    self.block_pool.decref(bid)
                    self.block_tables[i, blk] = new
                    self.slot_blocks[i][blk] = new
                    self.cow_count += 1
                    bid = new
                dst.append(bid * bs + p % bs)
                src_b.append(i)
                src_s.append(p - L)
        entry = quantize_kv_for_cache("k_scale" in self.pool, k_win, v_win)
        self._scatter(entry, dst, src_b, src_s)
        for i, _ in live:
            self._spec_release_leases(i)

        emitted_total = 0
        rids: List[int] = []
        emitted: Dict[int, int] = {}
        for (i, r), toks_out in zip(live, outs):
            self.lengths[i] = min(int(self.lengths[i]) + len(toks_out),
                                  self.max_seq)
            for t in toks_out:
                self._emit(r, i, t)
            emitted_total += len(toks_out)
            rids.append(r.rid)
            emitted[r.rid] = len(toks_out)
            if (toks_out[-1] == r.eos_id
                    or len(r.output) >= r.max_new_tokens):
                completed.append(r)      # done_time stamped at end of step
                r.status = DONE
                self._free_slot(i)
        self.draft_tokens += drafted
        self.accepted_tokens += accepted
        self.scheduler.note_spec_step()
        return {"tokens": emitted_total, "rids": rids, "drafted": drafted,
                "verified": W * len(live), "accepted": accepted,
                "emitted": emitted}

    def _free_slot(self, i: int):
        self.slots[i] = None
        self._slot_row[i] = None
        self._slot_emit0[i] = 0
        if self.kv_layout == "paged":
            self._spec_release_leases(i)
            for bid in self.slot_blocks[i]:
                self.block_pool.decref(bid)
            self.slot_blocks[i] = []
            self.block_tables[i] = 0
        self.lengths[i] = 0

    def _sample(self, logits, req: Request) -> np.ndarray:
        """(B, V) logits -> (B,) host token ids."""
        toks = sample_tokens(torch.as_tensor(logits), self.generator,
                             temperature=req.temperature)
        return toks.cpu().numpy()

    def _greedy(self, logits) -> np.ndarray:
        """Argmax over the last axis to host ids: `sample_tokens` at
        temperature 0, without the generator (`_spec_ready` admits greedy
        streams only)."""
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _emit(self, req: Request, slot: int, tok: int):
        if req.first_token_time is None:
            req.first_token_time = self.clock()
        req.output.append(tok)

    # -- telemetry ----------------------------------------------------------

    def recent_tps(self, window: int = 50) -> float:
        log = [s for s in self.step_log[-window:]
               if s["kind"] in ("decode", "spec_verify")]
        if not log:
            return 0.0
        return sum(s["tokens"] for s in log) / max(sum(s["dt"] for s in log), 1e-9)


class EngineClient:
    """Submission facade over a shared `ServingEngine`: several producers
    hold clients onto one engine, so their requests share decode steps."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    def submit(self, sreq: SessionRequest) -> RequestHandle:
        deadline = (None if sreq.deadline_s is None
                    else self.engine.clock() + sreq.deadline_s)
        req = Request(rid=self.engine.next_rid(), prompt=list(sreq.prompt),
                      max_new_tokens=sreq.max_new_tokens, eos_id=sreq.eos_id,
                      temperature=sreq.temperature, priority=sreq.priority,
                      deadline=deadline, tier=sreq.tier)
        return self.engine.submit(req)

    def step(self) -> List[Request]:
        return self.engine.step()

    def settle(self, handles: List[RequestHandle], *,
               max_steps: int = 100000) -> List[RequestHandle]:
        """Run the shared engine until every handle is terminal."""
        for _ in range(max_steps):
            if all(h.done() for h in handles):
                return handles
            if not self.engine.has_work():
                break
            self.engine.step()
        if not all(h.done() for h in handles):
            raise EngineStallError(
                f"{sum(not h.done() for h in handles)} session(s) not "
                f"terminal after {max_steps} steps "
                f"(active={self.engine.active}, "
                f"waiting={len(self.engine.pending)})")
        return handles
