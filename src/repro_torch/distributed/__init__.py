"""Distributed helpers of the port (`repro.distributed`): the int8
error-feedback gradient compressor (`compression`), the logical-axis
sharding rules on DTensor (`sharding`) and the GPipe pipeline schedule
over a stage axis (`pipeline`)."""
from .compression import (EFCompressor, compress_tree, dequantize_int8,
                          quantize_int8)

__all__ = ["EFCompressor", "compress_tree", "dequantize_int8",
           "quantize_int8"]
