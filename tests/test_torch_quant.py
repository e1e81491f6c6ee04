"""The port's weight quantization against the JAX package's: the same fp32
weights give bit-identical int8/uint8 payloads and f32 scales/zeros, and
`dense` agrees within the quant-matmul tolerance (relative < 0.02)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import dense as ref_dense
from repro.quant import quantize as ref_quantize
from repro.quant.qtensor import unpack_q4 as ref_unpack_q4

from repro_torch.common.registry import get_arch
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import get_model
from repro_torch.quant.qtensor import (QTensor, dense, dequantize,
                                       init_quantized, quant_spec, quantize,
                                       quantize_tree, unpack_q4)
from repro_torch.sharding import param as param_mod
from repro_torch.sharding.param import ParamDef, init_params


@pytest.mark.parametrize("fmt", ["q8", "q4"])
@pytest.mark.parametrize("shape", [(256, 384), (3, 128, 64), (512, 32)])
@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_quantize_bit_identical(fmt, shape, src):
    rng = np.random.default_rng(sum(shape) + (fmt == "q4"))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    wt = torch.as_tensor(w)
    wj = jnp.asarray(w)
    if src == "bf16":
        wt = wt.bfloat16()
        wj = jnp.asarray(wt.float().numpy()).astype(jnp.bfloat16)
    want = ref_quantize(wj, fmt)
    got = quantize(wt, fmt)
    assert (got.fmt, got.group) == (want.fmt, want.group)
    assert got.q.dtype == (torch.int8 if fmt == "q8" else torch.uint8)
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
    if fmt == "q4":
        assert np.array_equal(got.zero.numpy(), np.asarray(want.zero))
        assert np.array_equal(unpack_q4(got.q).numpy(),
                              np.asarray(ref_unpack_q4(want.q)))
        # even k in the low nibble
        assert np.array_equal((got.q & 0x0F).numpy(),
                              unpack_q4(got.q).numpy()[..., 0::2, :])
    assert got.shape == want.shape


@pytest.mark.parametrize("fmt", ["q8", "q4", "bf16"])
def test_dense_matches_reference(fmt):
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((2, 5, 256)),
                        dtype=torch.float32).bfloat16()
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    if fmt == "bf16":
        wt = torch.as_tensor(w).bfloat16()
        wj = jnp.asarray(wt.float().numpy()).astype(jnp.bfloat16)
    else:
        wt, wj = quantize(torch.as_tensor(w), fmt), ref_quantize(jnp.asarray(w), fmt)
    got = dense(x, wt)
    assert got.dtype == torch.bfloat16          # bf16 in, bf16 out
    want = np.asarray(ref_dense(xj, wj), np.float32)
    rel = np.max(np.abs(got.float().numpy() - want)) / np.max(np.abs(want))
    assert rel < 0.02, rel


def test_tree_quantization_and_leafwise_init():
    """`init_quantized` (leaf by leaf, the full-width path) gives the same
    trees as init_params + quantize_tree from the same generator seed."""
    cfg = reduce_config(get_arch("carboncall-qwen2-7b"))
    spec = get_model(cfg).param_spec()
    params = init_params(spec, torch.Generator().manual_seed(4), "cpu")
    streamed = init_quantized(spec, ("q8", "q4"),
                              torch.Generator().manual_seed(4), "cpu")
    for fmt in ("q8", "q4"):
        qspec = quant_spec(spec, fmt)
        tree = quantize_tree(params, spec, fmt)
        for name in ("wq", "wo"):
            a, b = tree["layers"]["attn"][name], streamed[fmt]["layers"]["attn"][name]
            assert isinstance(a, QTensor) and a.fmt == b.fmt
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
            assert tuple(a.q.shape) == qspec["layers"]["attn"][name].q.shape
        assert torch.equal(tree["embed"], streamed[fmt]["embed"])
    # q4 needs d_in % 128: the reduced width (64) falls back to q8, the
    # 128-wide MLP down projection takes q4
    assert streamed["q4"]["layers"]["attn"]["wq"].fmt == "q8"
    assert streamed["q4"]["layers"]["mlp"]["wo"].fmt == "q4"
    w = streamed["q8"]["lm_head"]
    assert dequantize(w, torch.float32).shape == w.shape


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _odd_spec():
    """A stacked q8-only leaf whose layer slice (33 x 35 = 1155 elements) is
    not a multiple of 16, a stacked leaf q4 can take, an unstacked head and
    a bias that stays unquantized."""
    return {"layers": {"w": ParamDef((3, 33, 35), ("layers", "embed", "mlp")),
                       "u": ParamDef((2, 256, 40), ("layers", "embed", "mlp")),
                       "b": ParamDef((3, 35), ("layers", None),
                                     init="small")},
            "head": ParamDef((256, 96), ("embed", "vocab"))}


@pytest.mark.parametrize("piece_elems", [None, 4096])
def test_per_layer_draw_matches_init_params(monkeypatch, piece_elems):
    """The per-layer draw: `init_quantized` (each leaf drawn one layer slice,
    or column block, at a time, quantized piece by piece into preallocated
    trees) equals `init_params` + `quantize_tree` from one seed, leaf for
    leaf, at the reduced carboncall-qwen2-7b and at a tree with a stacked
    leaf whose layer slice is not a multiple of 16 elements; with a small
    piece size the unstacked head is drawn in column blocks too."""
    if piece_elems is not None:
        monkeypatch.setattr(param_mod, "PIECE_ELEMS", piece_elems)
        assert len(param_mod.leaf_pieces(_odd_spec()["head"])) == 6
    specs = [_odd_spec(), get_model(
        reduce_config(get_arch("carboncall-qwen2-7b"))).param_spec()]
    for spec in specs:
        params = init_params(spec, torch.Generator().manual_seed(9), "cpu")
        drawn = init_quantized(spec, ("q8", "q4", "bf16"),
                               torch.Generator().manual_seed(9), "cpu")
        for fmt in ("q8", "q4", "bf16"):
            want = dict(_leaves(quantize_tree(params, spec, fmt)))
            got = dict(_leaves(drawn[fmt]))
            assert got.keys() == want.keys()
            for name, w in want.items():
                g = got[name]
                if isinstance(w, QTensor):
                    assert isinstance(g, QTensor) and g.fmt == w.fmt, name
                    for field in ("q", "scale", "zero"):
                        a, b = getattr(w, field), getattr(g, field)
                        assert (a is None) == (b is None), (name, field)
                        if a is not None:
                            assert a.dtype == b.dtype, (name, field)
                            assert torch.equal(a, b), (name, field)
                else:
                    assert w.dtype == g.dtype and torch.equal(w, g), name
        if spec is specs[0]:
            # 33 rows hold no q4 group: q8 in the q4 tree
            assert drawn["q4"]["layers"]["w"].fmt == "q8"
            assert drawn["q4"]["layers"]["u"].fmt == "q4"


def test_each_layer_slice_quantizes_to_its_qtensor():
    """Each layer's QTensor of the drawn variants is `quantize` of that
    layer's drawn slice, bit for bit, and the per-layer draw of a stacked
    leaf is its layer slices drawn one after another from the generator."""
    spec = _odd_spec()
    params = init_params(spec, torch.Generator().manual_seed(2), "cpu")
    drawn = init_quantized(spec, ("q8", "q4"),
                           torch.Generator().manual_seed(2), "cpu")
    gen = torch.Generator().manual_seed(2)
    w = params["layers"]["w"]
    std = 1.0 / 33 ** 0.5
    for i in range(w.shape[0]):
        x = torch.randn((33, 35), generator=gen, dtype=torch.float32)
        assert torch.equal(w[i], x.mul_(std).to(torch.bfloat16))
    for fmt in ("q8", "q4"):
        for name in ("w", "u"):
            leaf = params["layers"][name]
            tree = drawn[fmt]["layers"][name]
            for i in range(leaf.shape[0]):
                want = quantize(leaf[i], tree.fmt)
                got = tree[i]
                assert torch.equal(got.q, want.q), (fmt, name, i)
                assert torch.equal(got.scale, want.scale), (fmt, name, i)
                if want.zero is not None:
                    assert torch.equal(got.zero, want.zero), (fmt, name, i)
