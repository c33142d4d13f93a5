"""Architecture registry: one module per arch, the reference's ten: the
five LMs (``qwen2-7b``, ``yi-6b``, ``qwen1.5-32b``, ``deepseek-v2-236b``,
``llama4-maverick-400b-a17b``), ``dlrm-mlperf`` and the four GNNs
(``gcn-cora``, ``gin-tu``, ``schnet``, ``graphcast``)."""

from .base import (REGISTRY, ArchBundle, ShapeSpec, all_arch_ids,
                   config_for_shape, get_arch, input_specs)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (deepseek_v2_236b, dlrm_mlperf, gcn_cora, gin_tu,  # noqa
                   graphcast, llama4_maverick, qwen15_32b, qwen2_7b,
                   schnet, yi_6b)
    _LOADED = True


_load_all()

__all__ = ["REGISTRY", "ArchBundle", "ShapeSpec", "all_arch_ids",
           "config_for_shape", "get_arch", "input_specs"]
