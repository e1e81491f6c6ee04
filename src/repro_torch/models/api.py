"""Uniform Model API over the family modules the port serves so far: the
pattern-1 transformer and its MoE variant (dense and paged KV contracts),
the attention-free mamba2 LM and the Zamba2 hybrid (dense cache
contract)."""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig, RuntimeConfig
from repro_torch.models import hybrid, mamba2, transformer


def _module_for(cfg: ModelConfig):
    if cfg.family == "mamba2":
        return mamba2
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family not in ("transformer", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the other "
            "families are ROADMAP Queue 1 item 7")
    transformer.check_supported(cfg)
    return transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def mod(self):
        return _module_for(self.cfg)

    def param_spec(self):
        return self.mod.param_spec(self.cfg)

    def prefill(self, params, batch, rcfg: RuntimeConfig):
        """-> (last-position logits (B,V), the rows' cache entry, lengths
        (B,)): the prompt KV of the S written positions (transformer, moe),
        the per-layer {conv, ssm} states for the dense cache (mamba2), or
        both in the hybrid's cache tree."""
        return self.mod.prefill(params, batch, self.cfg, rcfg)

    # -- dense cache contract (every family) ----------------------------------

    def cache_spec(self, rcfg: RuntimeConfig, batch: int, max_seq: int):
        return self.mod.cache_spec(self.cfg, rcfg, batch, max_seq)

    def decode_step(self, params, cache, tokens, lengths, rcfg: RuntimeConfig,
                    positions=None):
        """-> (logits (B,V), cache updated in place)."""
        return self.mod.decode_step(params, cache, tokens, lengths, self.cfg,
                                    rcfg, positions=positions)

    # -- paged KV contract (transformer, moe) ---------------------------------

    def supports_paged(self) -> bool:
        return (self.cfg.family in ("transformer", "moe")
                and (self.cfg.local_global_pattern or 1) == 1
                and not self.cfg.use_mrope)

    def paged_cache_spec(self, rcfg: RuntimeConfig, num_blocks: int,
                         block_size: int):
        return self.mod.paged_cache_spec(self.cfg, rcfg, num_blocks,
                                         block_size)

    def prefill_paged(self, params, batch, prefix_k, prefix_v, prefix_lens,
                      rcfg: RuntimeConfig):
        """-> (last-position logits (B,V), suffix (k,v) (L,B,S_suf,K,H))."""
        return self.mod.prefill_paged(params, batch, prefix_k, prefix_v,
                                      prefix_lens, self.cfg, rcfg)

    def prefill_chunk(self, params, batch, prefix_k, prefix_v, prefix_lens,
                      rcfg: RuntimeConfig, *, need_logits: bool):
        """One chunked-prefill window over the already-prefilled prefix.
        -> (logits (B,V) or None, window (k,v) (L,B,S_win,K,H))."""
        return self.mod.prefill_chunk(params, batch, prefix_k, prefix_v,
                                      prefix_lens, self.cfg, rcfg,
                                      need_logits=need_logits)

    def verify_paged(self, params, batch, prefix_k, prefix_v, prefix_lens,
                     rcfg: RuntimeConfig):
        """Speculative verify over per-row k+1 windows, positions (B, W).
        -> (logits (B,W,V), window (k,v) (L,B,W,K,H))."""
        return self.mod.verify_paged(params, batch, prefix_k, prefix_v,
                                     prefix_lens, self.cfg, rcfg)

    def decode_step_paged(self, params, pool, tokens, lengths, block_tables,
                          rcfg: RuntimeConfig, *, seq_cap: int):
        """-> (logits (B,V), pool updated in place)."""
        return self.mod.decode_step_paged(params, pool, tokens, lengths,
                                          block_tables, self.cfg, rcfg,
                                          seq_cap=seq_cap)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
