"""DLRM (MLPerf config): sparse embedding tables + dot interaction + MLPs.

The port of ``src/repro/models/dlrm.py`` (serving: ``forward``, the value
of ``loss_fn``, ``serve_step``, ``retrieval_score``). The embedding lookup
is the hot path. The reference takes ``jnp.take(tab, jnp.minimum(idx,
V - 1))`` and a float32 sum over the bag; here each index is clamped to
V - 1 the same way and the bag summed by ``embedding_bag(table, idx,
mode="auto")``: on the card one of the two hand-written kernels
(``csrc/embedding_bag.cu``, bfloat16 rows widened to float32 and added in
slot order), on CPU tensors its plain version. ``use_kernels=False`` takes
the plain version on any device (the smoke test's yardstick). Without the
clamp an index >= V would be an empty slot there, not the last row.

Tables may be row-sharded over a device list (``devices=[...]`` with the
params of ``parallel.sharding.dlrm_param_sharding``): a bag-sum over a
row-sharded table is a local masked bag-sum per shard followed by a sum of
the partial bags on ``devices[0]`` (the reference's psum over the
``model`` axis): the sum over bag slots commutes with the shard sum, so no
rows move between devices.

The dense parts are plain PyTorch: the MLPs are ``x @ w + b`` in float32,
the interaction one ``torch.bmm`` and fixed lower-triangle indices, as the
reference leaves them to XLA outside any Pallas kernel. TF32 stays at
PyTorch's default (off), so the products are full float32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core.engine import resolve_torch_device
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.parallel.sharding import table_row_block

from . import layers as L
from .layers import abstractify, materialize

FDTYPE = torch.float32

# Criteo-1TB per-field vocabulary sizes (MLPerf DLRM benchmark config).
CRITEO_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    embed_dim: int = 128
    table_sizes: Tuple[int, ...] = CRITEO_TABLE_SIZES
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    hot: int = 1                      # multi-hot size per field
    sparse_optimizer: bool = False    # row-sparse table updates (§Perf)
    shard_moments_2d: bool = False    # ZeRO-style (model, dp) moment shard

    @property
    def n_sparse(self) -> int:
        return len(self.table_sizes)

    def params_count(self) -> int:
        n = sum(self.table_sizes) * self.embed_dim
        dims = [self.n_dense] + list(self.bot_mlp)
        n += sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        n_int = self.n_sparse + 1
        d_top = self.embed_dim + n_int * (n_int - 1) // 2
        dims = [d_top] + list(self.top_mlp)
        n += sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(dims) - 1))
        return n


def param_shapes(cfg: DLRMConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {}
    for t, v in enumerate(cfg.table_sizes):
        s[f"table{t}"] = ((v, cfg.embed_dim), L.PDTYPE)
    dims = [cfg.n_dense] + list(cfg.bot_mlp)
    for i in range(len(dims) - 1):
        s[f"bot_w{i}"] = ((dims[i], dims[i + 1]), FDTYPE)
        s[f"bot_b{i}"] = ((dims[i + 1],), FDTYPE)
    n_int = cfg.n_sparse + 1
    d_top = cfg.embed_dim + n_int * (n_int - 1) // 2
    dims = [d_top] + list(cfg.top_mlp)
    for i in range(len(dims) - 1):
        s[f"top_w{i}"] = ((dims[i], dims[i + 1]), FDTYPE)
        s[f"top_b{i}"] = ((dims[i + 1],), FDTYPE)
    return s


def init_params(cfg: DLRMConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Random params on ``device`` (``"cuda"`` raises without CUDA), drawn
    from ``generator`` (default: a generator on that device seeded 0) by
    the reference's name-aware rule (``layers.materialize``)."""
    dev = resolve_torch_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return materialize(param_shapes(cfg), generator, dev)


def param_specs(cfg: DLRMConfig) -> Dict[str, torch.Tensor]:
    return abstractify(param_shapes(cfg))


def _mlp(params, x, prefix, n):
    for i in range(n):
        x = x @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


@functools.lru_cache(maxsize=64)
def _clamp_bounds(sizes: Tuple[int, ...], device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """(1, T, 1) of V_t - 1: every field's clamp in one op."""
    return torch.tensor([v - 1 for v in sizes], dtype=dtype,
                        device=device).view(1, -1, 1)


def _dense_params(params, devices) -> Dict[str, torch.Tensor]:
    """The MLP params: as they are, or (sharded params) their copies on
    ``devices[0]``."""
    if devices is None:
        return params
    return {k: v[0] for k, v in params.items() if not k.startswith("table")}


def _sharded_bag(bag, shards: Sequence[torch.Tensor], idx: torch.Tensor,
                 blk: int, devices: Sequence) -> torch.Tensor:
    """One field's bags over a row-sharded table: per shard, the indices
    outside its block sent to PAD (= its row count) before the launch, the
    local bag-sum, then the partial bags summed on ``devices[0]`` in shard
    order."""
    out = None
    for i, (shard, dev) in enumerate(zip(shards, devices)):
        local = idx.to(dev) - i * blk
        local = torch.where((local >= 0) & (local < blk), local, blk)
        part = bag(shard, local).to(devices[0])
        out = part if out is None else out + part
    return out


def embedding_lookups(cfg: DLRMConfig, params, sparse: torch.Tensor, *,
                      use_kernels: bool = True,
                      devices: Optional[Sequence] = None
                      ) -> List[torch.Tensor]:
    """The 26 (here ``cfg.n_sparse``) bag-sums of ``sparse`` (B, T, hot):
    per field t, ``table_t[min(idx, V_t - 1)]`` widened to float32 and
    summed over the bag, a (B, D) float32 tensor. ``use_kernels`` picks
    ``embedding_bag`` (the kernels on the card) or its plain version.
    With ``devices``, ``params`` are ``dlrm_param_sharding``'s per-device
    lists and every result lies on ``devices[0]``."""
    bag = embedding_bag if use_kernels else embedding_bag_ref
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    bounds = _clamp_bounds(tuple(cfg.table_sizes), sparse.device,
                           sparse.dtype)
    # (T, B, hot): each field's clamped indices contiguous
    clamped = torch.minimum(sparse, bounds).transpose(0, 1).contiguous()
    out = []
    for t, v in enumerate(cfg.table_sizes):
        tab = params[f"table{t}"]
        if devices is None:
            out.append(bag(tab, clamped[t]))
            continue
        blk = table_row_block(v, len(devices))
        if blk:
            out.append(_sharded_bag(bag, tab, clamped[t], blk, devices))
        else:
            out.append(bag(tab[0], clamped[t]))
    return out


def _on(batch, key: str, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(batch[key], dtype=dtype, device=device)


def forward(cfg: DLRMConfig, params, batch: Dict[str, Any], *,
            use_kernels: bool = True,
            devices: Optional[Sequence] = None) -> torch.Tensor:
    """batch: dense (B, 13) f32, sparse (B, 26, hot) int32 -> logits (B,).
    Arrays or tensors; moved to the params' device (``devices[0]`` when
    the tables are sharded)."""
    p = _dense_params(params, devices)
    dev = p["bot_w0"].device
    dense = _on(batch, "dense", dev, FDTYPE)
    sparse = _on(batch, "sparse", dev)
    x_dense = _mlp(p, dense, "bot", len(cfg.bot_mlp))            # (B, D)
    embs = embedding_lookups(cfg, params, sparse, use_kernels=use_kernels,
                             devices=devices)
    z = torch.stack([x_dense] + embs, dim=1)                     # (B, 27, D)
    # dot interaction: lower-triangular pairwise dots
    zz = torch.bmm(z, z.transpose(1, 2))                         # (B, 27, 27)
    n_int = cfg.n_sparse + 1
    iu, ju = torch.tril_indices(n_int, n_int, offset=-1, device=dev)
    pairs = zz[:, iu, ju]                                        # (B, 351)
    top_in = torch.cat([x_dense, pairs], dim=-1)
    return _mlp(p, top_in, "top", len(cfg.top_mlp))[:, 0]


def loss_fn(cfg: DLRMConfig, params, batch, **kw):
    """(loss, {"bce": loss}): the mean BCE-with-logits of ``forward``, in
    the reference's numerically stable form. The value only: the tables'
    gradient (the lookup's backward) is not ported."""
    logits = forward(cfg, params, batch, **kw)
    y = _on(batch, "labels", logits.device, FDTYPE)
    loss = torch.mean(torch.clamp_min(logits, 0) - logits * y +
                      torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, {"bce": loss}


def serve_step(cfg: DLRMConfig, params, batch, **kw) -> torch.Tensor:
    """Online/offline scoring: forward only, sigmoid CTR."""
    return torch.sigmoid(forward(cfg, params, batch, **kw))


def retrieval_score(cfg: DLRMConfig, params, batch, *,
                    use_kernels: bool = True,
                    devices: Optional[Sequence] = None):
    """retrieval_cand shape: one query against n_candidates item vectors.

    query: dense (1, 13) + sparse (1, 26, hot) -> user vector via the bottom
    tower plus each field's bag, added one by one in field order;
    candidates (C, D) scored by one product, the top min(100, C) returned
    as (scores, indices), each (1, k), best first."""
    p = _dense_params(params, devices)
    dev = p["bot_w0"].device
    dense = _on(batch, "dense", dev, FDTYPE)
    x_user = _mlp(p, dense, "bot", len(cfg.bot_mlp))             # (1, D)
    for vec in embedding_lookups(cfg, params, _on(batch, "sparse", dev),
                                 use_kernels=use_kernels, devices=devices):
        x_user = x_user + vec
    cand = _on(batch, "candidates", dev, FDTYPE)                 # (C, D)
    scores = x_user @ cand.T                                     # (1, C)
    k = min(100, cand.shape[0])
    top_s, top_i = torch.topk(scores, k, dim=-1)
    return top_s, top_i


class DLRM(nn.Module):
    """The module idiom over the functions above: the params (random from
    ``generator`` on ``device``, or given) held as frozen parameters."""

    def __init__(self, cfg: DLRMConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, generator, device)
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in params.items()})

    def forward(self, batch, *, use_kernels: bool = True) -> torch.Tensor:
        return forward(self.cfg, dict(self.params), batch,
                       use_kernels=use_kernels)

    def serve_step(self, batch, *, use_kernels: bool = True) -> torch.Tensor:
        return serve_step(self.cfg, dict(self.params), batch,
                          use_kernels=use_kernels)

    def retrieval_score(self, batch, *, use_kernels: bool = True):
        return retrieval_score(self.cfg, dict(self.params), batch,
                               use_kernels=use_kernels)
