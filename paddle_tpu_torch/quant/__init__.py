"""Quantization — the port of paddle_tpu/quant (weight-only int8)."""
from .wo8 import (WeightOnlyInt8Embedding, WeightOnlyInt8Linear,
                  channelwise_int8, quantize_for_decode,
                  quantize_weights_int8)

__all__ = ["WeightOnlyInt8Linear", "WeightOnlyInt8Embedding",
           "quantize_weights_int8", "quantize_for_decode",
           "channelwise_int8"]
