"""Optimizer of the port: AdamW + schedules + global-norm clipping +
gradient compression (top-k / int8 with error feedback); counterpart of
``repro.optim``."""
from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from .schedule import cosine_schedule, linear_warmup
from .compression import (CompressionState, compress_topk, decompress_topk,
                          compressed_allreduce_init, int8_compress, int8_decompress)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "linear_warmup", "CompressionState",
           "compress_topk", "decompress_topk", "compressed_allreduce_init",
           "int8_compress", "int8_decompress"]
