"""Update compression for the shard→root hop of the combine — port of
``repro/compress``: top-k sparsification with error feedback and
symmetric per-leaf int8 quantization, wired into the engine's compressed
cross-shard combine (``EngineConfig.combine_compress``) by
:mod:`repro_torch.compress.combine`.
"""

from repro_torch.compress.combine import (CombineCompressor, make_encode_step,
                                          payload_nbytes)
from repro_torch.compress.quant import int8_dequantize, int8_quantize
from repro_torch.compress.topk import (TopKState, topk_compress,
                                       topk_decompress, topk_init, topk_k)

__all__ = [
    "TopKState", "topk_init", "topk_compress", "topk_decompress", "topk_k",
    "int8_quantize", "int8_dequantize", "CombineCompressor",
    "make_encode_step", "payload_nbytes",
]
