"""Box scheduling (``sharding``) and the distributed box fabric
(``fabric``: ``Fabric`` over ``QueryEngine`` shards).

``fabric`` imports the engines, whose executor imports ``sharding``, so
its names load on first use."""

from repro_torch.parallel.sharding import (ShardSlice, balanced_box_schedule,
                                           box_mass_costs, box_mass_costs_nd,
                                           box_mesh, box_queue_order,
                                           interval_gaps,
                                           iter_shard_local_csr,
                                           local_slice_shape, lpt_order,
                                           merge_interval,
                                           shard_local_slices,
                                           shard_shipped_ranges)

_FABRIC = ("Fabric", "FabricLayout", "FabricShippingError", "FabricStats",
           "ShardReport", "ShippedEdgeSource")

__all__ = sorted(_FABRIC + (
    "ShardSlice", "balanced_box_schedule", "box_mass_costs",
    "box_mass_costs_nd", "box_mesh", "box_queue_order", "interval_gaps",
    "iter_shard_local_csr", "local_slice_shape", "lpt_order",
    "merge_interval", "shard_local_slices",
    "shard_shipped_ranges"))


def __getattr__(name):
    if name in _FABRIC:
        from repro_torch.parallel import fabric
        return getattr(fabric, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
