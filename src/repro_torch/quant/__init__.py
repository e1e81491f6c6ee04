from repro_torch.quant.qtensor import (
    QTensor,
    dense,
    dequantize,
    quant_spec,
    quantize,
    quantize_tree,
)

__all__ = ["QTensor", "quantize", "dequantize", "quantize_tree", "dense", "quant_spec"]
