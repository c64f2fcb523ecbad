"""Configurations of the PyTorch port: the scheduler's (``cocktail_paper``)
and the ported LM architectures (``base``: ``ArchConfig``, ``get_config``,
``reduced``, the input-shape grid ``SHAPES`` and ``LONG_CONTEXT_OK``)."""
from .base import (ARCH_IDS, LONG_CONTEXT_OK, SHAPES, ArchConfig, all_configs, get_config,
                   reduced, register)

__all__ = ["ARCH_IDS", "ArchConfig", "LONG_CONTEXT_OK", "SHAPES", "all_configs", "get_config",
           "reduced", "register"]
