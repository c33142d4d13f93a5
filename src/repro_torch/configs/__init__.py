"""Architecture registry: one module per ported arch. The reference
registers ten archs; the port registers each with its model, and so far
only ``dlrm-mlperf``."""

from .base import (REGISTRY, ArchBundle, ShapeSpec, all_arch_ids,
                   config_for_shape, get_arch, input_specs)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import dlrm_mlperf  # noqa: F401
    _LOADED = True


_load_all()

__all__ = ["REGISTRY", "ArchBundle", "ShapeSpec", "all_arch_ids",
           "config_for_shape", "get_arch", "input_specs"]
