"""Architecture registry: one module per ported arch. The reference
registers ten archs; the port registers each with its model: so far
``dlrm-mlperf`` and the four GNNs (``gcn-cora``, ``gin-tu``, ``schnet``,
``graphcast``)."""

from .base import (REGISTRY, ArchBundle, ShapeSpec, all_arch_ids,
                   config_for_shape, get_arch, input_specs)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import dlrm_mlperf  # noqa: F401
    from . import gcn_cora, gin_tu, graphcast, schnet  # noqa: F401
    _LOADED = True


_load_all()

__all__ = ["REGISTRY", "ArchBundle", "ShapeSpec", "all_arch_ids",
           "config_for_shape", "get_arch", "input_specs"]
