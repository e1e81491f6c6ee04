"""Dynamic tool selection (paper §III-B).

The port of `repro.core.tool_select`. Pipeline per query:
  1. sentence split (complex queries decompose — Eq. 2's S = {s_1..s_m}),
  2. encode sentences + (pre-built) tool index with the shared embedder,
  3. exact top-k retrieval, Score(t_j) = max_i cos(s_i, t_j) (Eq. 3 — the
     FAISS role): `kernels.topk_sim.ops.topk_tools`, which runs the
     hand-written CUDA kernel (one launch from raw query embeddings to the
     top k) when the index lives on the card and its plain version when it
     lives on the CPU,
  4. cross-encoder re-rank of the top-k in full context,
  5. adaptive cut: one tool when the margin to the runner-up is decisive,
     else several (reduces prompt tokens vs a fixed k),
  6. NER/keyword augmentation: query terms that hit the keyword->tool map
     force-include their tools (catches retrieval misses on entity-ish terms).

The index and the query embeddings live on the selector's device, which
defaults to the card. Each `retrieve` copies its top-k scores and indices
back to the host in one copy (the rerank and the cut run in numpy /
Python).
"""
from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.config import RuntimeConfig
from repro_torch.core import embedder as E
from repro_torch.data.workload import ToolCatalog
from repro_torch.kernels.topk_sim import ops as topk_ops

_SENT_SPLIT = re.compile(r"[.!?;]\s+|\band then\b|\bafter that\b")
INDEX_PAD = 256                  # index rows are padded to a multiple of this


def split_sentences(text: str) -> List[str]:
    parts = [p.strip() for p in _SENT_SPLIT.split(text)]
    return [p for p in parts if p] or [text]


@dataclasses.dataclass
class SelectionResult:
    tool_ids: List[int]
    scores: List[float]
    retrieved: List[int]           # pre-rerank top-k (for diagnostics)
    from_keywords: List[int]


class ToolSelector:
    def __init__(self, catalog: ToolCatalog, *,
                 rcfg: Optional[RuntimeConfig] = None,
                 k: int = 16, max_tools: int = 4,
                 margin: float = 0.15,
                 cross_encoder: str = "lexical",
                 encoder_mode: str = "bow",
                 encoder_params=None, cross_params=None,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device, "ToolSelector")
        self.catalog = catalog
        self.rcfg = rcfg or RuntimeConfig()
        self.k = k
        self.max_tools = max_tools
        self.margin = margin
        self.tok = E.HashTokenizer()
        self.encoder_mode = encoder_mode
        self.encoder_params = encoder_params if encoder_params is not None \
            else E.init_encoder(self._generator(seed), self.device)
        self.cross_mode = cross_encoder
        if cross_encoder == "lexical":
            self.cross = E.LexicalCrossEncoder(self.tok, catalog.texts)
        else:
            self.cross_params = cross_params if cross_params is not None \
                else E.init_cross(self._generator(seed), self.device)
        self.keyword_map = catalog.keyword_map()
        # build the index: IDF weights + embed every tool description, zero
        # rows padding it to a multiple of INDEX_PAD (they score exactly 0.0
        # and are dropped after the top-k) — this is the FAISS build step
        texts = catalog.texts
        self.idf = E.idf_weights(self.tok, texts)
        self._idf = torch.from_numpy(self.idf).to(self.device)
        emb = self._encode(texts).to(torch.float32)
        pad = (-len(texts)) % INDEX_PAD
        if pad:
            emb = torch.cat([emb, emb.new_zeros((pad, emb.shape[1]))])
        self.index = emb.contiguous()
        self.n_tools = len(texts)

    @staticmethod
    def _generator(seed: int) -> torch.Generator:
        """The encoder trees are drawn on the CPU and moved to the selector's
        device, so one seed gives the same selections on the CPU and on the
        card (a CUDA generator would draw other numbers)."""
        return torch.Generator().manual_seed(seed)

    def _encode(self, texts: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(self.tok.encode_batch(texts)).to(self.device)
        return E.encode_texts(self.encoder_params, ids, self.rcfg,
                              mode=self.encoder_mode, idf=self._idf)

    # -- stages --------------------------------------------------------------

    def retrieve(self, query: str) -> Tuple[List[int], List[float]]:
        sents = split_sentences(query)
        q_emb = self._encode(sents)
        k = min(self.k * max(1, len(sents) // 2 + 1), self.index.shape[0])
        scores, idx = topk_ops.topk_tools(self.index, q_emb, k=k, host=True)
        idx, scores = idx.numpy(), scores.numpy()
        keep = idx < self.n_tools
        return list(idx[keep]), list(scores[keep])

    def rerank(self, query: str, cand: Sequence[int]) -> List[Tuple[int, float]]:
        """Cross-encoder scoring in full context, per sentence (a chain step's
        tool should win on *its* sentence — max over sentences, like Eq. 3)."""
        if not cand:
            return []
        texts = [self.catalog.tools[i].description for i in cand]
        sents = split_sentences(query)
        if self.cross_mode == "lexical":
            s = np.max(np.stack([self.cross.score_batch(sent, texts)
                                 for sent in sents]), axis=0)
        else:
            pairs = np.stack([E.pair_tokens(self.tok, sent, t)
                              for sent in sents for t in texts])
            raw = E.cross_score(self.cross_params,
                                torch.from_numpy(pairs).to(self.device),
                                self.rcfg).cpu().numpy()
            s = raw.reshape(len(sents), len(texts)).max(axis=0)
        order = np.argsort(-s)
        return [(int(cand[i]), float(s[i])) for i in order]

    def keyword_hits(self, query: str) -> List[int]:
        # sorted set iteration: Python set order depends on PYTHONHASHSEED and
        # would leak nondeterminism into selection results
        words = sorted(set(self.tok.words(query)))
        hits = []
        for w in words:
            for tid in self.keyword_map.get(w, ()):
                hits.append(tid)
        # keep tools hit by >= 2 distinct keywords (precision guard),
        # strongest matches first, deterministic tie-break
        c = Counter(hits)
        return [tid for tid, n in sorted(c.items(), key=lambda kv: (-kv[1], kv[0]))
                if n >= 2]

    def adaptive_cut(self, ranked: List[Tuple[int, float]],
                     n_sentences: int) -> List[Tuple[int, float]]:
        if not ranked:
            return []
        if len(ranked) == 1:
            return ranked[:1]
        top, second = ranked[0][1], ranked[1][1]
        rel_margin = (top - second) / (abs(top) + 1e-9)
        if n_sentences == 1 and rel_margin > self.margin:
            return ranked[:1]
        want = min(self.max_tools, max(n_sentences, 2))
        return ranked[:want]

    # -- full pipeline ---------------------------------------------------------

    def select(self, query: str) -> SelectionResult:
        cand, _ = self.retrieve(query)
        # NER/keyword augmentation feeds the rerank pool too: retrieval misses
        # on entity/domain terms still reach the cross-encoder (paper §III-B
        # last paragraph)
        kw = self.keyword_hits(query)
        pool = list(dict.fromkeys(list(cand) + kw))
        ranked = self.rerank(query, pool)
        n_sent = len(split_sentences(query))
        cut = self.adaptive_cut(ranked, n_sent)
        chosen = [t for t, _ in cut]
        scores = [s for _, s in cut]
        extra = [t for t in kw if t not in chosen]
        chosen += extra[: max(0, self.max_tools + 2 - len(chosen))]
        return SelectionResult(tool_ids=chosen, scores=scores,
                               retrieved=list(cand),
                               from_keywords=kw)
