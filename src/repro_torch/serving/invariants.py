"""Engine invariant checker: the port's copy of `repro.serving.invariants`.

The reconciliations read the same step-log and counter fields in both
packages, so one corrupted engine state yields the same violations from
either checker.

It checks:

  * `tokens_emitted` reconciles with the step log;
  * every admission appears as a logged "prefill" row, every non-final
    chunk window as a "prefill_chunk" row, and no parked partial prefill
    survives a drain;
  * every speculative step appears as a "spec_verify" row, its per-rid
    emitted counts reconcile with outputs, drafted/accepted counters match
    the log, and no draft scratch lease survives a drain;
  * requeues equal preemptions; terminal statuses match per-tier counters;
  * every request's emitted-token count equals its logged prefill+decode
    appearances, and an expired request holds no resume state;
  * (paged) block-pool refcounts reconcile exactly with the prefix cache's
    holdings once all slots are free, and — with ``flush=True`` — return to
    the empty-pool baseline after a cache flush.

Call only on a DRAINED engine (no active slots, no waiting queue): the
refcount reconciliation assumes every remaining block reference is a
prefix-cache hold.
"""
from __future__ import annotations

import collections
from typing import List, Sequence

from repro_torch.serving.scheduler import CANCELLED, DONE, EXPIRED, TERMINAL


def check_invariants(engine, reqs: Sequence, *, flush: bool = True
                     ) -> List[str]:
    """Reconcile `engine` counters/pool state against its step log and the
    full request set `reqs`; returns human-readable violations (empty =
    all invariants hold). With ``flush=True`` the prefix cache is cleared
    at the end to verify the pool returns to its empty baseline —
    destructive, so run it last."""
    errs: List[str] = []

    def check(cond: bool, msg: str):
        if not cond:
            errs.append(msg)

    log = engine.step_log
    check(engine.tokens_emitted == sum(s["tokens"] for s in log),
          "tokens_emitted != step_log token sum")
    dec_count: collections.Counter = collections.Counter()
    fresh_count: collections.Counter = collections.Counter()
    for s in log:
        if s["kind"] == "decode":
            for r in s["rids"]:
                dec_count[r] += 1
        elif s["kind"] == "spec_verify":
            # spec rows emit a per-rid token COUNT (accepted prefix + the
            # verify token), recorded in the row's `emitted` map
            for r, n in s["emitted"].items():
                dec_count[r] += n
        elif s["tokens"] > 0:            # fresh admissions emit one token;
            for r in s["rids"]:          # resume re-prefills emit none
                fresh_count[r] += 1
    stats = engine.scheduler_stats()
    check(stats["admitted"] == sum(
        len(s["rids"]) for s in log if s["kind"] == "prefill"),
        "admitted != logged prefill rows")
    check(stats["chunk_steps"] == sum(
        1 for s in log if s["kind"] == "prefill_chunk"),
        "chunk_steps != logged prefill_chunk rows")
    check(stats.get("spec_steps", 0) == sum(
        1 for s in log if s["kind"] == "spec_verify"),
        "spec_steps != logged spec_verify rows")
    check(sum(s.get("accepted", 0) for s in log)
          == getattr(engine, "accepted_tokens", 0),
          "accepted_tokens != step_log accepted sum")
    check(sum(s.get("drafted", 0) for s in log)
          == getattr(engine, "draft_tokens", 0),
          "draft_tokens != step_log drafted sum")
    check(all(not lease for lease in getattr(engine, "_spec_leases", [])),
          "draft scratch lease survived the drain")
    check(all(not r.chunk_blocks and r.chunk_row is None for r in reqs),
          "parked partial prefill survived the drain")
    check(stats["requeues"] == stats["preemptions"],
          "requeues != preemptions")
    check(stats["waiting"] == 0, "waiting queue not drained")
    by_status = collections.Counter(r.status for r in reqs)
    check(stats["expired"] == by_status[EXPIRED],
          "expired counter != EXPIRED requests")
    check(stats["cancelled"] == by_status[CANCELLED],
          "cancelled counter != CANCELLED requests")
    tiers = stats["tiers"]
    check(sum(t["submitted"] for t in tiers.values()) == len(reqs),
          "tier submitted counters != request count")
    for key, status in (("done", DONE), ("expired", EXPIRED),
                        ("cancelled", CANCELLED)):
        check(sum(t[key] for t in tiers.values()) == by_status[status],
              f"tier {key!r} counters != {status} requests")
    for req in reqs:
        check(req.status in TERMINAL, f"rid {req.rid} not terminal")
        check(fresh_count[req.rid] <= 1,
              f"rid {req.rid} fresh-admitted more than once")
        check(len(req.output) == fresh_count[req.rid] + dec_count[req.rid],
              f"rid {req.rid} output != logged appearances")
        if req.status == EXPIRED:
            check(req.resume_row is None,
                  f"expired rid {req.rid} still holds resume state")

    if engine.kv_layout == "paged":
        pool = engine.block_pool
        held: collections.Counter = collections.Counter()
        for e in engine.prefix_cache.entries.values():
            for b in e.blocks:
                held[b] += 1
        for bid in range(pool.num_blocks):
            check(pool.refcount[bid] == held.get(bid, 0),
                  f"block {bid}: refcount {pool.refcount[bid]} != "
                  f"cache holds {held.get(bid, 0)}")
        if flush:
            engine.prefix_cache.clear()
            check(pool.num_free == pool.num_blocks - 1,
                  "pool not at empty baseline after cache flush")
            check((pool.refcount == 0).all(),
                  "nonzero refcounts after cache flush")
    return errs
