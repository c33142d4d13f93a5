"""Config registry: architectures × input shapes (assignment cells).

Each arch file registers an ArchBundle; ``input_specs(arch, shape)`` builds
stand-ins for every model input of that cell: tensors on torch's ``meta``
device (shape and dtype, no allocation), where the reference builds
``jax.ShapeDtypeStruct``s.

Step kinds per shape (assignment):
  LM:   train_4k -> train_step · prefill_32k -> prefill_step ·
        decode_32k / long_500k -> serve_step (1 new token vs KV cache)
  GNN:  all four graph shapes -> train_step (full-batch or sampled block)
  DLRM: train_batch -> train_step · serve_p99/serve_bulk -> serve_step ·
        retrieval_cand -> retrieval_step

The shape tables are the reference's, all three, and all ten archs
register (``configs/__init__.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

REGISTRY: Dict[str, "ArchBundle"] = {}

I32 = torch.int32
F32 = torch.float32


@dataclass
class ShapeSpec:
    name: str
    step: str                  # train | prefill | decode | serve | retrieval
    dims: Dict[str, int] = field(default_factory=dict)


@dataclass
class ArchBundle:
    arch_id: str
    family: str                # lm | gnn | recsys
    config: Any                # full-size model config
    smoke_config: Any          # reduced config for CPU smoke tests
    shapes: Dict[str, ShapeSpec]
    notes: str = ""

    def shape_names(self):
        return list(self.shapes)


def register(bundle: ArchBundle) -> ArchBundle:
    REGISTRY[bundle.arch_id] = bundle
    return bundle


def get_arch(arch_id: str) -> ArchBundle:
    """The registered bundle of ``arch_id``; ``KeyError`` naming it when it
    is not registered."""
    if arch_id not in REGISTRY:
        from . import _load_all
        _load_all()
    if arch_id not in REGISTRY:
        raise KeyError(f"arch {arch_id!r} is not registered in repro_torch "
                       f"(registered: {sorted(REGISTRY)})")
    return REGISTRY[arch_id]


def all_arch_ids():
    from . import _load_all
    _load_all()
    return sorted(REGISTRY)


# ---------------------------------------------------------------------------
# canonical shape tables (from the assignment)
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          dict(seq=4096, batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             dict(seq=32768, batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            dict(seq=32768, batch=128)),
    "long_500k": ShapeSpec("long_500k", "decode",
                           dict(seq=524288, batch=1)),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train",
                               dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                                    n_classes=7)),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
             fanout=(15, 10), d_feat=602, n_classes=41,
             # padded sampled-block sizes (seeds + 1-hop + 2-hop)
             blk_nodes=1024 * (1 + 15 + 150), blk_edges=1024 * (15 + 150))),
    "ogb_products": ShapeSpec("ogb_products", "train",
                              dict(n_nodes=2449029, n_edges=61859140,
                                   d_feat=100, n_classes=47)),
    "molecule": ShapeSpec("molecule", "train",
                          dict(n_nodes=30, n_edges=64, batch=128, d_feat=30,
                               d_target=1)),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}


# ---------------------------------------------------------------------------
# input_specs builders
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the meta device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def lm_input_specs(cfg, spec: ShapeSpec) -> Dict[str, Any]:
    b, s = spec.dims["batch"], spec.dims["seq"]
    if spec.step == "train":
        return {"tokens": _spec((b, s), I32), "targets": _spec((b, s), I32)}
    if spec.step == "prefill":
        return {"tokens": _spec((b, s), I32)}
    if spec.step == "decode":
        from repro_torch.models.transformer import cache_specs
        return {"cache": cache_specs(cfg, b, s),
                "token": _spec((b, 1), I32),
                "pos": _spec((), I32)}
    raise ValueError(spec.step)


def _pad_to(n: int, m: int = 512) -> int:
    """Graph sizes are padded to multiples of the full mesh size (512) so
    node/edge arrays shard evenly; masks zero out the padding."""
    return ((n + m - 1) // m) * m


def gnn_input_specs(cfg, spec: ShapeSpec) -> Dict[str, Any]:
    d = spec.dims
    if spec.name == "minibatch_lg":
        n, e = d["blk_nodes"], d["blk_edges"]
    elif spec.name == "molecule":
        n = d["n_nodes"] * d["batch"]
        e = d["n_edges"] * d["batch"]
    else:
        n, e = d["n_nodes"], d["n_edges"]
    n, e = _pad_to(n), _pad_to(e)
    out: Dict[str, Any] = {
        "node_feat": _spec((n, d["d_feat"]), F32),
        "edge_src": _spec((e,), I32),
        "edge_dst": _spec((e,), I32),
        "edge_mask": _spec((e,), F32),
        "node_mask": _spec((n,), F32),
    }
    if spec.name == "molecule":
        # per-node regression (atomic-energy style); positions for SchNet
        out["pos"] = _spec((n, 3), F32)
        out["graph_id"] = _spec((n,), I32)
        out["targets"] = _spec((n, d["d_target"]), F32)
    else:
        out["labels"] = _spec((n,), I32)
        out["label_mask"] = _spec((n,), F32)
    return out


def config_for_shape(arch_id: str, shape_name: str, smoke: bool = False):
    """Specialize the arch config to a shape (GNN d_in/d_out track the
    graph's feature/label dims; LM/recsys configs are shape-independent)."""
    bundle = get_arch(arch_id)
    cfg = bundle.smoke_config if smoke else bundle.config
    if bundle.family != "gnn":
        return cfg
    spec = bundle.shapes[shape_name]
    d = spec.dims
    d_in = d["d_feat"]
    d_out = d.get("d_target", d.get("n_classes", cfg.d_out))
    return dataclasses.replace(cfg, d_in=d_in, d_out=d_out)


def recsys_input_specs(cfg, spec: ShapeSpec) -> Dict[str, Any]:
    b = spec.dims["batch"]
    out = {"dense": _spec((b, cfg.n_dense), F32),
           "sparse": _spec((b, cfg.n_sparse, cfg.hot), I32)}
    if spec.step == "train":
        out["labels"] = _spec((b,), F32)
    if spec.step == "retrieval":
        out["candidates"] = _spec(
            (spec.dims["n_candidates"], cfg.embed_dim), F32)
    return out


def input_specs(arch_id: str, shape_name: str, smoke: bool = False,
                cfg=None, dims: Optional[Dict[str, Any]] = None):
    """(step_kind, specs) for a cell; smoke=True uses the reduced config.
    ``cfg`` overrides the registry config (probe/transformed cells);
    ``dims`` overrides entries of the shape's dims (a cell cut to fit one
    card, ``launch.perf``)."""
    bundle = get_arch(arch_id)
    if cfg is None:
        cfg = bundle.smoke_config if smoke else bundle.config
    spec = bundle.shapes[shape_name]
    if dims:
        spec = dataclasses.replace(spec, dims={**spec.dims, **dims})
    if bundle.family == "lm":
        return spec.step, lm_input_specs(cfg, spec)
    if bundle.family == "gnn":
        return spec.step, gnn_input_specs(cfg, spec)
    if bundle.family == "recsys":
        return spec.step, recsys_input_specs(cfg, spec)
    raise ValueError(bundle.family)
