"""The port's tool selection against the JAX package's, on the CPU.

  * the plain `sim_scores` / `topk_tools` (what a CPU tensor takes in the
    port's wrapper) against the Pallas kernel in interpret mode and the
    reference oracle, on the same numpy inputs, with zero pad rows and exact
    ties: scores within SCORE_TOL, indices equal, ties included; also at a
    ToolBench-sized catalog and at k = N with a zero query row among the raw
    queries;
  * the plain `top_k` against `jax.lax.top_k` on signed zeros and equal
    values: +0.0 ranks above -0.0, equal bits by lower index;
  * the tokenizer, the IDF weights and the lexical cross-encoder, exactly;
  * `encode_texts` and `cross_score` with the reference's `init_encoder(0)` /
    `init_cross(0)` weights carried over by `repro_torch.bridge`;
  * `ToolSelector.select` over a stream of seeded queries: chosen tools,
    retrieved lists and keyword hits identical, scores within SCORE_TOL;
    `ToolSelector.retrieve` likewise;
  * the fused retrieval's wrapper, against a stand-in for the CUDA library:
    one launcher call with the plan's arguments and one launch count, and
    k outside 1..N refused before any launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedder as RE
from repro.core.tool_select import ToolSelector as RefToolSelector
from repro.data.workload import FunctionCallWorkload as RefWorkload
from repro.data.workload import build_catalog as ref_build_catalog
from repro.kernels.topk_sim import ops as ref_ops
from repro.kernels.topk_sim import ref as ref_ref
from repro.kernels.topk_sim import topk_sim as ref_kernel

from repro_torch import kernels
from repro_torch.bridge import params_from_numpy
from repro_torch.core import embedder as PE
from repro_torch.core.tool_select import ToolSelector
from repro_torch.data.workload import FunctionCallWorkload, build_catalog
from repro_torch.kernels.topk_sim import ops
from repro_torch.kernels.topk_sim import ref

# f32 dots of 256 products summed in different orders by XLA and torch
# differ around 1e-7; the ROADMAP tolerance for retrieval scores is 1e-5.
SCORE_TOL = 1e-5
# max |diff| of the unit embeddings from the same weights. bow is f32
# arithmetic only (measured 9e-8). hybrid and contextual add the 2-layer bf16
# transformer, whose hidden states the two packages round at different
# places (up to 2 bf16 steps at |h| ~ 4.6): measured 6.7e-4 (hybrid) and
# 1.2e-3 (contextual) on these inputs, so 1e-5 cannot hold there.
EMBED_TOL = {"bow": 1e-5, "hybrid": 2e-3, "contextual": 5e-3}
# cross_score pools the same bf16 hidden states through an f32 head: measured
# max |diff| 3.5e-3 (mean 1.1e-3) on scores of magnitude up to 0.47
CROSS_TOL = 1e-2
N_QUERIES = 200


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _retrieval_inputs(N, d, m, seed, zero_row=None):
    """Normalised tools, raw queries and the queries normalised. Nine rows in
    ten point away from every query (their scores are negative), so the 16
    zero pad rows at the end, which score exactly 0.0, fall inside the top k
    at the catalog's size; copies of the best row give exact ties at the
    top. A `zero_row` query row is all zeros: it scores 0.0 on every tool,
    so every row that points away ties at exactly 0.0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((m, d)).astype(np.float32)
    qn = _unit(q)
    if zero_row is not None:
        q[zero_row] = qn[zero_row] = 0.0
    tools = _unit(rng.standard_normal((N, d)))
    away = rng.random(N) < 0.9
    noise = rng.standard_normal((N, d)) * (0.5 / np.sqrt(d))
    tools[away] = _unit(-qn.sum(0) + noise[away])
    best = int(np.argmax((tools @ qn.T).max(1)))
    tools[7::31] = tools[best]              # exact ties at the top
    tools[N - 16:] = 0.0                    # index padding
    return tools, q, qn


@pytest.mark.parametrize("N,d,m,k", [(256, 256, 1, 16), (256, 256, 3, 32),
                                     (1024, 256, 8, 16), (512, 64, 5, 8)])
def test_plain_topk_matches_reference(N, d, m, k):
    tools, q, qn = _retrieval_inputs(N, d, m, seed=N + m)
    t_tools, t_q, t_qn = (torch.from_numpy(a) for a in (tools, q, qn))

    want = np.asarray(ref_kernel.sim_scores(
        jnp.asarray(tools), jnp.asarray(qn), bt=min(1024, N), interpret=True))
    got = ref.sim_scores_ref(t_tools, t_qn).numpy()
    assert np.max(np.abs(got - want)) <= SCORE_TOL
    assert ops.sim_scores(t_tools, t_qn).numpy().tolist() == got.tolist()

    # through the normalising entry points: Pallas (interpret) vs plain
    w_s, w_i = ref_ops.topk_tools(jnp.asarray(tools), jnp.asarray(q), k=k,
                                  interpret=True)
    before = kernels.launch_counts()["sim_scores"]
    g_s, g_i = ops.topk_tools(t_tools, t_q, k=k)
    assert kernels.launch_counts()["sim_scores"] == before  # plain on CPU
    assert g_i.tolist() == np.asarray(w_i).tolist()
    assert np.max(np.abs(g_s.numpy() - np.asarray(w_s))) <= SCORE_TOL
    # and the oracles on the normalised queries
    o_s, o_i = ref_ref.topk_tools_ref(jnp.asarray(tools), jnp.asarray(qn), k)
    p_s, p_i = ref.topk_tools_ref(t_tools, t_qn, k)
    assert p_i.tolist() == np.asarray(o_i).tolist()
    assert np.max(np.abs(p_s.numpy() - np.asarray(o_s))) <= SCORE_TOL
    # the inputs do exercise ties: equal scores inside the top k
    top = p_s.numpy()
    assert len(set(top.tolist())) < k


def test_topk_orders_ties_by_index():
    scores = torch.tensor([0.0, 0.5, 0.0, 0.5, -1.0, 0.0])
    vals, idx = ref.top_k(scores, 5)
    assert idx.tolist() == [1, 3, 0, 2, 5]
    assert vals.tolist() == [0.5, 0.5, 0.0, 0.0, 0.0]


def test_topk_orders_signed_zeros_as_jax():
    """+0.0 ranks above -0.0 and equal bits keep the lower index first, as
    in `jax.lax.top_k` (a stable sort on the values alone ties the zeros)."""
    scores = np.array([0.0, -0.0, 0.5, 0.0, -0.0, 0.5, -0.1, -0.0, 0.0, 1.0,
                       -1.0, 0.5], np.float32)
    want_s, want_i = jax.lax.top_k(jnp.asarray(scores), len(scores))
    got_s, got_i = ref.top_k(torch.from_numpy(scores), len(scores))
    assert got_i.tolist() == np.asarray(want_i).tolist()
    assert got_i.tolist()[:8] == [9, 2, 5, 11, 0, 3, 8, 1]
    assert np.array_equal(got_s.numpy().view(np.int32),
                          np.asarray(want_s).view(np.int32))   # zeros' signs
    for k in (1, 4, 7):
        assert ref.top_k(torch.from_numpy(scores), k)[1].tolist() == \
            np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1]).tolist()


@pytest.mark.parametrize("N,m,k", [(16640, 3, 32), (256, 3, 256)])
def test_topk_tools_matches_reference_with_zero_query(N, m, k):
    """A ToolBench-sized catalog (16,464 tools padded to 16640 rows) and the
    full order at k = N, with a zero row among the raw queries: the Pallas
    path (interpret mode) against the port's CPU path."""
    tools, q, _ = _retrieval_inputs(N, 256, m, seed=N + k, zero_row=1)
    w_s, w_i = ref_ops.topk_tools(jnp.asarray(tools), jnp.asarray(q), k=k,
                                  interpret=True)
    g_s, g_i = ops.topk_tools(torch.from_numpy(tools), torch.from_numpy(q),
                              k=k)
    assert g_i.tolist() == np.asarray(w_i).tolist()
    assert np.max(np.abs(g_s.numpy() - np.asarray(w_s))) <= SCORE_TOL
    if k == N:      # the away rows and the pad rows tie at 0.0
        assert int((g_s == 0).sum()) > N // 2


class _FakeDevice:
    """Stands in for `ops._Device` on the CPU: records the launcher's
    arguments and the scratch asked for."""
    sms, counter_ptr = 132, 0

    def __init__(self):
        self.calls, self.scratch_keys = [], []

    def topk_fn(self, *args):
        self.calls.append(args)
        return 0

    def scratch(self, n):
        self.scratch_keys.append(n)
        return 0

    def stream(self):
        return 0


@pytest.mark.parametrize("N,d,m,k", [(256, 256, 1, 16), (256, 256, 2, 16),
                                     (256, 256, 3, 32), (16640, 256, 3, 32),
                                     (256, 256, 9, 256), (300, 63, 2, 5)])
def test_topk_wrapper_is_one_launch(monkeypatch, N, d, m, k):
    fake = _FakeDevice()
    monkeypatch.setitem(ops._DEVICES, torch.device("cpu"), fake)
    tools, q = torch.zeros((N, d)), torch.ones((m, d))
    before = kernels.launch_counts()["sim_scores"]
    s, i = ops.launch_topk(tools, q, k)
    assert kernels.launch_counts()["sim_scores"] == before + 1
    assert len(fake.calls) == 1 and s.shape == i.shape == (k,)
    assert (s.dtype, i.dtype) == (torch.float32, torch.int64)
    vec = d % 4 == 0
    p = ops.plan(N, d, m, k, 132, vec)
    args = fake.calls[0]
    assert args[:4] == (tools.data_ptr(), q.data_ptr(), s.data_ptr(),
                        i.data_ptr())
    assert args[4:12] == (N, d, m, k, p.mq, int(vec), int(p.lists), p.grid)
    assert fake.scratch_keys == [p.scratch]
    # the plan: query groups of up to 4 (4 for unaligned rows), one batch
    # of 4 rows a warp up to one block an SM, lists up to k = 32
    assert p.mq == (min(1 << (m - 1).bit_length(), 4) if vec else 4)
    assert p.groups == -(-m // p.mq)
    assert p.grid == min(-(-N // (ops.ROWS * ops.WARPS)), 132)
    assert p.lists == (k <= 32)
    assert p.scratch == (p.grid * 32 if p.lists else 1 << (N - 1).bit_length())
    # host=True: both into one buffer, the k indices then the k scores
    hs, hi = ops.launch_topk(tools, q, k, host=True)
    assert len(fake.calls) == 2 and hs.shape == hi.shape == (k,)
    assert (hs.dtype, hi.dtype) == (torch.float32, torch.int64)
    assert fake.calls[1][2] == fake.calls[1][3] + 8 * k == hs.data_ptr()
    for bad in (0, N + 1):
        with pytest.raises(ValueError):
            ops.launch_topk(tools, q, bad)
    assert len(fake.calls) == 2


def test_tokenizer_idf_and_lexical_scores_exact():
    cat = build_catalog(240, seed=0)
    texts = cat.texts
    queries = [q.text for q in FunctionCallWorkload(cat, seed=5).stream(40)]
    rtok, ptok = RE.HashTokenizer(), PE.HashTokenizer()
    assert np.array_equal(rtok.encode_batch(texts + queries),
                          ptok.encode_batch(texts + queries))
    assert np.array_equal(RE.idf_weights(rtok, texts),
                          PE.idf_weights(ptok, texts))
    rlex = RE.LexicalCrossEncoder(rtok, texts)
    plex = PE.LexicalCrossEncoder(ptok, texts)
    for q in queries:
        assert np.array_equal(rlex.score_batch(q, texts),
                              plex.score_batch(q, texts))
    for q, t in zip(queries, texts):
        assert np.array_equal(RE.pair_tokens(rtok, q, t),
                              PE.pair_tokens(ptok, q, t))


@pytest.fixture(scope="module")
def encoder():
    """The reference's init_encoder(0) weights and their numpy copy."""
    params = RE.init_encoder(0)
    return params, _to_numpy(params)


@pytest.mark.parametrize("which", ["encoder", "cross"])
def test_bridge_carries_encoder_and_cross_trees(encoder, which):
    """The reference's encoder and cross-encoder trees reach the port bit for
    bit (bf16 leaves as uint16 views), in the layout of the port's specs."""
    ref_np = encoder[1] if which == "encoder" else \
        _to_numpy(RE.init_cross(0))
    spec = PE.encoder_spec() if which == "encoder" else PE.cross_spec()
    port = params_from_numpy(ref_np, "cpu")

    def walk(r, p, d):
        if isinstance(d, dict):
            assert set(r) == set(p) == set(d)
            for k in d:
                walk(r[k], p[k], d[k])
            return
        assert tuple(p.shape) == r.shape == d.shape
        assert p.dtype == d.torch_dtype
        bits = p.view(torch.int16).numpy().view(np.uint16) \
            if p.dtype == torch.bfloat16 else p.numpy()
        want = r.view(np.uint16) if r.dtype.name == "bfloat16" else r
        assert np.array_equal(bits, want)

    walk(ref_np, port, spec)


@pytest.mark.parametrize("mode", ["bow", "hybrid", "contextual"])
def test_encode_texts_matches_reference(encoder, mode):
    ref_params, params_np = encoder
    cat = build_catalog(240, seed=0)
    tok = PE.HashTokenizer()
    texts = cat.texts[:48] + [q.text for q in
                              FunctionCallWorkload(cat, seed=9).stream(16)]
    ids = tok.encode_batch(texts)
    idf = PE.idf_weights(tok, cat.texts)
    want = np.asarray(RE.encode_texts(ref_params, jnp.asarray(ids),
                                      mode=mode, idf=idf))
    got = PE.encode_texts(params_from_numpy(params_np, "cpu"),
                          torch.from_numpy(ids), mode=mode,
                          idf=torch.from_numpy(idf)).numpy()
    assert got.shape == want.shape == (len(texts), PE.EMBED_DIM)
    assert np.max(np.abs(got - want)) <= EMBED_TOL[mode]


def test_cross_score_matches_reference():
    cat = build_catalog(240, seed=0)
    tok = PE.HashTokenizer()
    queries = [q.text for q in FunctionCallWorkload(cat, seed=11).stream(8)]
    pairs = np.stack([PE.pair_tokens(tok, q, t.description)
                      for q in queries for t in cat.tools[:8]])
    ref_params = RE.init_cross(0)
    want = np.asarray(RE.cross_score(ref_params, jnp.asarray(pairs)))
    got = PE.cross_score(params_from_numpy(_to_numpy(ref_params), "cpu"),
                         torch.from_numpy(pairs)).numpy()
    assert np.all(np.isfinite(got)) and got.shape == (len(pairs),)
    assert np.max(np.abs(got - want)) <= CROSS_TOL


def test_selector_matches_reference_on_query_stream(encoder):
    ref_sel = RefToolSelector(ref_build_catalog(240, seed=0))
    sel = ToolSelector(build_catalog(240, seed=0),
                       encoder_params=params_from_numpy(encoder[1], "cpu"),
                       device="cpu")
    assert sel.index.shape == tuple(ref_sel.index.shape) == (256, PE.EMBED_DIM)
    assert np.max(np.abs(sel.index.numpy() - np.asarray(ref_sel.index))) \
        <= SCORE_TOL
    ref_q = RefWorkload(ref_sel.catalog, seed=3).stream(N_QUERIES)
    port_q = FunctionCallWorkload(sel.catalog, seed=3).stream(N_QUERIES)
    n_chain = 0
    for rq, pq in zip(ref_q, port_q):
        assert rq.text == pq.text and rq.true_tools == pq.true_tools
        n_chain += len(pq.sentences) > 1
        want, got = ref_sel.select(rq.text), sel.select(pq.text)
        assert [int(t) for t in got.retrieved] == \
            [int(t) for t in want.retrieved], rq.text
        assert got.from_keywords == want.from_keywords
        assert got.tool_ids == want.tool_ids, rq.text
        assert len(got.scores) == len(want.scores)
        assert np.max(np.abs(np.subtract(got.scores, want.scores)),
                      initial=0.0) <= SCORE_TOL
    assert n_chain > 20                      # multi-sentence queries covered


def test_retrieve_matches_reference(encoder):
    """`retrieve` (top k with one copy to the host) returns the reference's
    lists: indices identical, scores within SCORE_TOL, as Python lists."""
    ref_sel = RefToolSelector(ref_build_catalog(240, seed=0))
    sel = ToolSelector(build_catalog(240, seed=0),
                       encoder_params=params_from_numpy(encoder[1], "cpu"),
                       device="cpu")
    n_multi = 0
    for pq in FunctionCallWorkload(sel.catalog, seed=7).stream(40):
        want_i, want_s = ref_sel.retrieve(pq.text)
        got_i, got_s = sel.retrieve(pq.text)
        assert isinstance(got_i, list) and isinstance(got_s, list)
        assert [int(t) for t in got_i] == [int(t) for t in want_i], pq.text
        assert np.max(np.abs(np.subtract(got_s, want_s)), initial=0.0) \
            <= SCORE_TOL
        n_multi += len(pq.sentences) > 1
    assert n_multi > 0                       # k grows with the sentences
