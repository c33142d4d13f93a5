"""dlrm-mlperf [arXiv:1906.00091; paper]: MLPerf DLRM (Criteo 1TB).

n_dense=13 n_sparse=26 embed_dim=128 bot=13-512-256-128
top=1024-1024-512-256-1 interaction=dot.
"""

from repro_torch.models.dlrm import CRITEO_TABLE_SIZES, DLRMConfig

from .base import RECSYS_SHAPES, ArchBundle, register


def _pad512(v: int) -> int:
    """Vocabs padded to multiples of 512 so tables shard over any mesh
    axis combination (§Perf dlrm_train v0: unpadded Criteo sizes are not
    divisible by 16 and silently fell back to full replication — 240 GiB
    of tables+moments per device). Pad rows are never referenced."""
    return ((v + 511) // 512) * 512


CONFIG = DLRMConfig(
    name="dlrm-mlperf", n_dense=13, embed_dim=128,
    table_sizes=tuple(_pad512(v) for v in CRITEO_TABLE_SIZES),
    bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1), hot=1,
    sparse_optimizer=True, shard_moments_2d=True)

SMOKE_CONFIG = DLRMConfig(
    name="dlrm-smoke", n_dense=13, embed_dim=16,
    table_sizes=(100, 50, 20, 7),
    bot_mlp=(32, 16), top_mlp=(32, 16, 1), hot=3)

register(ArchBundle(
    arch_id="dlrm-mlperf", family="recsys", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=RECSYS_SHAPES,
    notes="~24B embedding params (188M rows x 128); tables vocab-sharded "
          "over the model axis, bag-sum psum-combined (DESIGN.md §5). The "
          "lookup is the join Bags ⋈ Table — probe/provision machinery "
          "reused for budgeted shard prefetch."))
