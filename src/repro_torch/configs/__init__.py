"""Configurations of the PyTorch port: the scheduler's (``cocktail_paper``)
and the ported LM architectures (``base``: ``ArchConfig``, ``get_config``,
``reduced``)."""
from .base import ARCH_IDS, ArchConfig, all_configs, get_config, reduced, register

__all__ = ["ARCH_IDS", "ArchConfig", "all_configs", "get_config", "reduced", "register"]
