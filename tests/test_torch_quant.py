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
from repro_torch.sharding.param import init_params


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
