"""Core library: LFTJ, boxing, the streaming triangle engine and the
paper's public triangle API (with the MGT baseline and the Prop. 4
adversarial instance)."""

from .triearray import SPILL, TrieArray, TrieArraySlice
from .leapfrog import (Atom, LeapfrogJoin, LeapfrogTriejoin, TrieIterator,
                       lftj_triangle_count, triangle_query_atoms)
from .boxing import (BoxedLFTJ, BoxingConfig, BoxStats, SkewPlan,
                     boxed_triangle_count, class_cuts, classify_heavy,
                     greedy_degree_cuts, heavy_threshold_default, plan_boxes,
                     plan_boxes_from_degrees, plan_boxes_heavy_light)
from .executor import BoxSlice, SliceCache, StreamingExecutor
from .iomodel import BlockDevice, CountingReader, IOStats
from .lftj_torch import (csr_from_edges, dense_adjacency, orient_edges,
                         pad_neighbors, pad_neighbors_binned,
                         triangle_count_boxed_vectorized,
                         triangle_count_dense, triangle_count_vectorized)
from .engine import (EngineStats, TriangleEngine, engine_count, engine_list,
                     measure_dense_crossover, measure_fused_crossover,
                     measure_intersect_crossover, resolve_torch_device)
from .mgt import mgt_triangle_count
from .queries import (Query, best_order, best_rank, build_indexes, rank,
                      rank_for_order, reordered_index, run_query, validate)
from .triangle import brute_force_count, count_triangles, list_triangles
from .adversarial import adversarial_graph

__all__ = [
    "SPILL", "TrieArray", "TrieArraySlice", "Atom", "LeapfrogJoin",
    "LeapfrogTriejoin", "TrieIterator", "lftj_triangle_count",
    "triangle_query_atoms", "BoxedLFTJ", "BoxingConfig", "BoxStats",
    "boxed_triangle_count", "plan_boxes", "BlockDevice", "CountingReader",
    "IOStats", "csr_from_edges", "orient_edges", "pad_neighbors",
    "triangle_count_boxed_vectorized", "triangle_count_dense",
    "triangle_count_vectorized", "mgt_triangle_count", "Query", "best_rank",
    "build_indexes", "rank_for_order", "run_query", "brute_force_count",
    "count_triangles", "list_triangles", "adversarial_graph",
    "pad_neighbors_binned", "EngineStats", "TriangleEngine", "engine_count",
    "engine_list", "measure_dense_crossover", "plan_boxes_from_degrees",
    "BoxSlice", "SliceCache", "StreamingExecutor", "rank", "validate",
    "best_order", "reordered_index", "greedy_degree_cuts",
    "measure_intersect_crossover", "SkewPlan", "class_cuts",
    "classify_heavy", "heavy_threshold_default", "plan_boxes_heavy_light",
    "measure_fused_crossover", "dense_adjacency", "resolve_torch_device",
]
