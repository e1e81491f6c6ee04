"""Uniform Model API over the family modules (transformer family only in
the port so far)."""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig, RuntimeConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def mod(self):
        transformer.check_supported(self.cfg)
        return transformer

    def param_spec(self):
        return self.mod.param_spec(self.cfg)

    def prefill(self, params, batch, rcfg: RuntimeConfig):
        """-> (last-position logits (B,V), prompt KV entry, lengths (B,))."""
        return self.mod.prefill(params, batch, self.cfg, rcfg)

    # -- paged KV contract ---------------------------------------------------

    def supports_paged(self) -> bool:
        return (self.cfg.family == "transformer"
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

    def decode_step_paged(self, params, pool, tokens, lengths, block_tables,
                          rcfg: RuntimeConfig, *, seq_cap: int):
        """-> (logits (B,V), pool updated in place)."""
        return self.mod.decode_step_paged(params, pool, tokens, lengths,
                                          block_tables, self.cfg, rcfg,
                                          seq_cap=seq_cap)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
