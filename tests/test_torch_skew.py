"""repro_torch's ``skew="heavy_light"`` engine against the reference on the
CPU.

The port runs with ``torch_device="cpu"``; the reference runs its own CPU
lanes. Boxes, their hub/light/mixed lanes, the hub degree cut, the lane
counts, ``padded_words`` / ``actual_words``, counts and ``list()`` bytes
must all be equal. The routing the card takes (hub boxes to the dense or
fused lane, light and mixed boxes to the host lane, the ``fused_threshold``
band) is checked on ``_pick_backend`` alone, with kernels switched on by
hand and no launch.
"""

import numpy as np
import pytest

from repro.core import TriangleEngine as RefEngine
from repro.data import graphs as r_graphs
from repro_torch import TriangleEngine
from repro_torch.convert import engine_from_state


def star_graph(hubs, leaves, seed):
    """A few hubs adjacent to every leaf plus a sprinkle of leaf-leaf
    edges: a couple of huge rows over tiny ones."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(hubs), leaves)
    dst = hubs + np.tile(np.arange(leaves), hubs)
    extra = rng.integers(hubs, hubs + leaves, size=(leaves, 2))
    extra = extra[extra[:, 0] < extra[:, 1]]
    src = np.concatenate([src, extra[:, 0]])
    dst = np.concatenate([dst, extra[:, 1]])
    uniq = np.unique(src * (hubs + leaves) + dst)
    return (uniq // (hubs + leaves)).astype(np.int64), \
        (uniq % (hubs + leaves)).astype(np.int64)


GRAPHS = {
    "er": lambda: r_graphs.random_graph(150, 1200, seed=4),
    "rmat": lambda: r_graphs.rmat_graph(200, 1800, seed=1),
    "star": lambda: star_graph(4, 60, 3),
}

STAT_FIELDS = ("n_boxes", "n_dense_boxes", "n_binary_boxes", "n_host_boxes",
               "n_fused_boxes", "n_rescans", "padded_words", "actual_words",
               "device_invocations", "max_box_device_invocations",
               "n_streamed_boxes", "slice_words_read", "max_slice_words",
               "max_slice_padded_words", "skew", "heavy_threshold",
               "n_hub_boxes", "n_light_boxes", "n_mixed_boxes")


def _stats(stats):
    return {f: getattr(stats, f) for f in STAT_FIELDS}


def _run(eng):
    count = eng.count()
    count_stats = _stats(eng.stats)
    tris = eng.list()
    return count, count_stats, tris, _stats(eng.stats)


def _assert_same(r_eng, p_eng):
    ref, port = _run(r_eng), _run(p_eng)
    assert p_eng.plan() == r_eng.plan()
    assert p_eng._box_lane == r_eng._box_lane
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2].tobytes() == ref[2].tobytes() and len(port[2]) == port[0]
    assert port[3] == ref[3]
    return port


def _cases():
    cases = []
    for g in sorted(GRAPHS):
        for orient in ("minmax", "degree"):
            for mem in (None, 800):
                for workers in (1, 4):
                    cases.append((g, orient, mem, workers, None))
    # explicit hub cuts that give hub, light and mixed boxes at test size
    cases += [("rmat", "minmax", 800, 1, 8), ("rmat", "degree", 800, 4, 6),
              ("star", "minmax", 300, 1, 20), ("er", "minmax", 800, 1, 10)]
    return cases


@pytest.mark.parametrize("graph,orient,mem,workers,thr", _cases())
def test_heavy_light_matches_reference(graph, orient, mem, workers, thr):
    src, dst = GRAPHS[graph]()
    kw = dict(mem_words=mem, orientation=orient, workers=workers,
              skew="heavy_light", heavy_threshold=thr)
    port = _assert_same(RefEngine(src, dst, shard=False, **kw),
                        TriangleEngine(src, dst, torch_device="cpu", **kw))
    stats = port[1]
    assert stats["skew"] == "heavy_light" and stats["heavy_threshold"] > 0
    assert stats["n_hub_boxes"] + stats["n_light_boxes"] \
        + stats["n_mixed_boxes"] == stats["n_boxes"]
    if thr is not None:
        assert stats["heavy_threshold"] == thr
        assert stats["n_hub_boxes"] > 0


def test_heavy_light_stats_reset_for_uniform():
    src, dst = GRAPHS["rmat"]()
    eng = TriangleEngine(src, dst, mem_words=800, torch_device="cpu")
    eng.count()
    s = eng.stats
    assert (s.skew, s.heavy_threshold, s.n_hub_boxes, s.n_light_boxes,
            s.n_mixed_boxes) == ("uniform", 0, 0, 0, 0)


def _card_pair(src, dst, **kw):
    """A reference engine with its kernels on and a CPU port engine with
    ``use_kernels`` set by hand: routing only, nothing launches."""
    ref = RefEngine(src, dst, use_pallas_kernels=True, shard=False, **kw)
    port = TriangleEngine(src, dst, torch_device="cpu", **kw)
    assert not port.use_kernels
    port.use_kernels = True
    return ref, port


LANE_NAMES = {"intersect": "pallas"}


def test_heavy_light_routes_on_the_card_like_reference_on_tpu():
    """Hub boxes go dense while the one-hot estimate fits and fused past
    it; light and mixed boxes go to the host lane."""
    src, dst = GRAPHS["rmat"]()
    ref, port = _card_pair(src, dst, mem_words=800, skew="heavy_light",
                           heavy_threshold=8)
    assert port.plan() == ref.plan() and port._box_lane == ref._box_lane
    seen = set()
    for box in ref.plan():
        for n_edges in (1, 50, 4000, 10 ** 6):
            for wx, wy in ((3, 5), (400, 900), (5000, 20000),
                           (500_000, 500_000)):
                want = ref._pick_backend(n_edges, wx, wy, box)
                got = port._pick_backend(n_edges, wx, wy, box)
                assert LANE_NAMES.get(got, got) == want, (box, n_edges)
                seen.add((port._box_lane[box], got))
    assert {("hub", "dense"), ("hub", "fused"), ("light", "host"),
            ("mixed", "host")} <= seen
    # off the card a hub box past the one-hot cap takes the binary lane
    port.use_kernels = False
    hub = next(b for b, lane in port._box_lane.items() if lane == "hub")
    assert port._pick_backend(10 ** 6, 500_000, 500_000, hub) == "binary"


def test_fused_threshold_band_routes_on_the_card_like_reference_on_tpu():
    src, dst = GRAPHS["er"]()
    ref, port = _card_pair(src, dst, fused_threshold=0.03)
    assert port.fused_threshold == ref.fused_threshold == 0.03
    lanes = set()
    for n_edges in (0, 1, 5, 20, 40, 60, 200, 400, 5000, 10 ** 7):
        for wx, wy in ((32, 32), (100, 100), (1000, 17), (4000, 4000)):
            want = ref._pick_backend(n_edges, wx, wy)
            got = port._pick_backend(n_edges, wx, wy)
            assert LANE_NAMES.get(got, got) == want, (n_edges, wx, wy)
            lanes.add(got)
    assert {"dense", "fused", "intersect", "binary"} <= lanes
    # off the card the fused band is never taken
    port.use_kernels = False
    assert "fused" not in {port._pick_backend(n, 100, 100)
                           for n in (300, 400, 450)}


@pytest.mark.parametrize("orient", ["minmax", "degree"])
def test_engine_from_state_carries_heavy_light_lanes(orient):
    """The reference's heavy_light plan and lanes, carried across by
    engine_from_state, route box for box as they do there."""
    src, dst = GRAPHS["rmat"]()
    r_eng = RefEngine(src, dst, mem_words=700, orientation=orient,
                      shard=False, skew="heavy_light", heavy_threshold=8)
    plan = r_eng.plan()
    state = {"indptr": r_eng.indptr, "indices": r_eng.indices,
             "orientation": r_eng.orientation, "nv": r_eng.nv,
             "plan": plan, "lanes": [r_eng._box_lane[b] for b in plan]}
    p_eng = engine_from_state(state, mem_words=700, torch_device="cpu")
    assert p_eng.skew == "uniform"             # the lanes alone steer it
    assert p_eng.plan() == plan and p_eng._box_lane == r_eng._box_lane
    r_count, p_count = r_eng.count(), p_eng.count()
    assert p_count == r_count
    for f in ("n_hub_boxes", "n_light_boxes", "n_mixed_boxes",
              "n_dense_boxes", "n_host_boxes", "n_binary_boxes",
              "padded_words", "actual_words"):
        assert getattr(p_eng.stats, f) == getattr(r_eng.stats, f), f
    assert p_eng.stats.n_host_boxes > 0 and p_eng.stats.n_hub_boxes > 0
    assert p_eng.list().tobytes() == r_eng.list().tobytes()


def test_engine_from_state_rejects_bad_lanes():
    src, dst = GRAPHS["er"]()
    r_eng = RefEngine(src, dst, mem_words=700, shard=False,
                      skew="heavy_light")
    state = {"indptr": r_eng.indptr, "indices": r_eng.indices,
             "orientation": "minmax", "nv": r_eng.nv,
             "lanes": ["hub"]}
    with pytest.raises(ValueError, match="plan"):
        engine_from_state(state, torch_device="cpu")
    state["plan"] = r_eng.plan()
    state["lanes"] = ["hub"] * (len(state["plan"]) + 1)
    with pytest.raises(ValueError, match="lanes"):
        engine_from_state(state, torch_device="cpu")
