"""Sentence embedder + cross-encoder for tool selection, in PyTorch.

The port of `repro.core.embedder`. No pretrained checkpoint is used, so the
substrate is built from scratch:

  * HashTokenizer — word-level feature hashing (lowercase, alnum split,
    id = md5-stable hash % vocab). Deterministic, training-free.
  * SentenceEncoder — embedding table + 2-layer mean-pooled transformer with a
    projection head (`ENCODER_CFG`). Even untrained (fixed random init) it is
    a random projection of bag-of-words features, so lexical overlap =>
    cosine similarity.
  * CrossEncoder — scores (query, tool) jointly. Two backends:
      - "lexical": IDF-weighted token-overlap scoring (deterministic,
        training-free; the runtime's default),
      - "transformer": 2-layer joint encoder with scalar head (`CROSS_CFG`).

Weights are built on a device from a `torch.Generator`; the JAX package's
weights cross through `repro_torch.bridge` for parity tests. The
transformer modes run the port's `models.transformer.forward`, so on the
card their attention is the flash kernel (head dim 32) and their linears
plain bf16 products. The contrastive loss that trains the encoder comes
with the training slice (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig, RuntimeConfig
from repro_torch.sharding.param import ParamDef, init_params


_WORD_RE = re.compile(r"[a-z0-9_]+")


def _stable_hash(word: str) -> int:
    return int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")


@dataclasses.dataclass(frozen=True)
class HashTokenizer:
    vocab_size: int = 8192
    max_len: int = 32

    def words(self, text: str) -> List[str]:
        return _WORD_RE.findall(text.lower())

    def encode(self, text: str) -> np.ndarray:
        ids = [2 + _stable_hash(w) % (self.vocab_size - 2) for w in self.words(text)]
        ids = ids[: self.max_len]
        ids += [0] * (self.max_len - len(ids))
        return np.array(ids, np.int32)

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])


# ---------------------------------------------------------------------------
# Sentence encoder
# ---------------------------------------------------------------------------


ENCODER_CFG = ModelConfig(
    name="tool-encoder", family="transformer", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=8192)
EMBED_DIM = 256


def idf_weights(tokenizer: "HashTokenizer", corpus: Sequence[str]) -> np.ndarray:
    """Per-hashed-token IDF over a corpus -> (vocab,) f32. Down-weights the
    boilerplate words every tool description shares."""
    df = np.zeros(tokenizer.vocab_size, np.float32)
    for text in corpus:
        ids = {2 + _stable_hash(w) % (tokenizer.vocab_size - 2)
               for w in tokenizer.words(text)}
        for i in ids:
            df[i] += 1.0
    n = max(len(corpus), 1)
    w = np.log((n + 1.0) / (df + 0.5))
    return (w / w.max()).astype(np.float32)


def encoder_spec():
    from repro_torch.models.transformer import param_spec
    spec = param_spec(ENCODER_CFG)
    spec.pop("lm_head")
    spec["proj"] = ParamDef((ENCODER_CFG.d_model, EMBED_DIM), ("embed", None))
    return spec


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 denom: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) * mask[..., None]).sum(1) / denom


def encode_texts(params, token_ids: torch.Tensor,
                 rcfg: Optional[RuntimeConfig] = None, *,
                 mode: str = "hybrid", idf: Optional[torch.Tensor] = None):
    """token_ids: (B, T) on the params' device -> L2-normalized embeddings
    (B, EMBED_DIM) f32.

    mode:
      * "bow"        — IDF-weighted mean of the embedding table + projection.
                       A random projection of bag-of-words features:
                       training-free and lexical-overlap-faithful (untrained
                       default for the retrieval index).
      * "contextual" — full transformer pass (use after training).
      * "hybrid"     — 0.7*bow + 0.3*contextual, normalized.
    `idf` is a (vocab,) f32 tensor on the same device, or None.
    """
    from repro_torch.models.transformer import forward
    rcfg = rcfg or RuntimeConfig()
    mask = (token_ids != 0).to(torch.float32)
    if idf is not None:
        mask = mask * idf[token_ids.long()]
    denom = torch.clamp_min(mask.sum(1, keepdim=True), 1e-3)
    bow = _masked_mean(params["embed"][token_ids.long()], mask, denom)
    if mode == "bow":
        pooled = bow
    else:
        h, _ = forward(params, {"tokens": token_ids}, ENCODER_CFG, rcfg)
        ctx = _masked_mean(h, mask, denom)
        pooled = ctx if mode == "contextual" else 0.7 * bow + 0.3 * ctx
    emb = pooled @ params["proj"].to(torch.float32)
    return emb / torch.clamp_min(
        torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-9)


def init_encoder(generator: torch.Generator, device):
    """Random encoder weights on `device`, drawn from `generator` on its own
    device (`ToolSelector` passes a CPU generator for every device)."""
    return init_params(encoder_spec(), generator, device)


# ---------------------------------------------------------------------------
# Cross encoders
# ---------------------------------------------------------------------------


class LexicalCrossEncoder:
    """IDF-weighted overlap: deterministic re-ranker (runtime default)."""

    def __init__(self, tokenizer: HashTokenizer, corpus: Sequence[str]):
        self.tok = tokenizer
        df: dict = {}
        for text in corpus:
            for w in sorted(set(self.tok.words(text))):
                df[w] = df.get(w, 0) + 1
        n = max(len(corpus), 1)
        self.idf = {w: float(np.log((n + 1) / (c + 0.5))) for w, c in df.items()}
        self.default_idf = float(np.log(n + 1))

    def score(self, query: str, tool_text: str) -> float:
        qw = set(self.tok.words(query))
        tw = set(self.tok.words(tool_text))
        # sorted iteration: float summation order must not depend on
        # PYTHONHASHSEED (eps-level differences flip argsort ties downstream)
        inter = sorted(qw & tw)
        s = sum(self.idf.get(w, self.default_idf) for w in inter)
        norm = sum(self.idf.get(w, self.default_idf) for w in sorted(tw)) + 1e-9
        return s / norm

    def score_batch(self, query: str, tool_texts: Sequence[str]) -> np.ndarray:
        return np.array([self.score(query, t) for t in tool_texts], np.float32)


CROSS_CFG = ModelConfig(
    name="tool-cross", family="transformer", num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=8192)


def cross_spec():
    from repro_torch.models.transformer import param_spec
    spec = param_spec(CROSS_CFG)
    spec.pop("lm_head")
    spec["head"] = ParamDef((CROSS_CFG.d_model, 1), ("embed", None))
    return spec


def cross_score(params, pair_tokens: torch.Tensor,
                rcfg: Optional[RuntimeConfig] = None) -> torch.Tensor:
    """pair_tokens: (B, T) — query ++ [SEP=1] ++ tool text -> scores (B,)."""
    from repro_torch.models.transformer import forward
    rcfg = rcfg or RuntimeConfig()
    mask = (pair_tokens != 0).to(torch.float32)
    h, _ = forward(params, {"tokens": pair_tokens}, CROSS_CFG, rcfg)
    pooled = _masked_mean(h, mask,
                          torch.clamp_min(mask.sum(1, keepdim=True), 1.0))
    return (pooled @ params["head"].to(torch.float32))[:, 0]


def init_cross(generator: torch.Generator, device):
    return init_params(cross_spec(), generator, device)


def pair_tokens(tok: HashTokenizer, query: str, tool_text: str,
                max_len: int = 64) -> np.ndarray:
    q = [2 + _stable_hash(w) % (tok.vocab_size - 2) for w in tok.words(query)]
    t = [2 + _stable_hash(w) % (tok.vocab_size - 2) for w in tok.words(tool_text)]
    ids = (q[: max_len // 2] + [1] + t)[: max_len]
    ids += [0] * (max_len - len(ids))
    return np.array(ids, np.int32)
