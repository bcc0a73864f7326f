"""Distributed helpers of the port (`repro.distributed`).  Ported: the
int8 error-feedback gradient compressor (`compression`).  The sharding
rules and the pipeline schedule are ROADMAP §1 item 13."""
from .compression import (EFCompressor, compress_tree, dequantize_int8,
                          quantize_int8)

__all__ = ["EFCompressor", "compress_tree", "dequantize_int8",
           "quantize_int8"]
