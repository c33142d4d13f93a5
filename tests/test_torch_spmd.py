"""repro_torch's grid runtime (``parallel.spmd``) on ``["cpu"] * 4``.

  * ``place`` then ``gather`` gives back a tensor bit for bit for every
    partition spec the grid cells use, on the (2, 2) and (1, 4) grids; a
    split dimension that does not divide raises, and a dimension the
    rules leave whole (``P()``) round-trips; blocks on their source's
    device are views, and places on one device share a replicated block.
  * Each collective equals a numpy loop in grid order (place 0 first)
    bit for bit: all-gather, reduce-scatter (equal and uneven parts),
    all-reduce (float32, and bfloat16 summed in float32 and rounded
    once), all-to-all and fetch, over ``model``, ``data`` and both; its
    backward equals the dual collective of the cotangents.
  * The ledger's counts and bytes equal the closed form of each op
    (operand bytes of one device, one op a call, nothing for a one-place
    group), and an abstract grid's one ``meta`` place reckons the same
    ledger and shapes as the four real places.
  * ``lockstep`` runs per-place generators to their ends, and raises
    where places disagree at a collective.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_grid
from repro_torch.parallel import spmd
from repro_torch.parallel.sharding import NamedSharding, P

GRIDS = [(2, 2), (1, 4)]
DP = ("data",)
# every partition spec the slice's cells put on their arguments and outputs
SPECS = [P(), P(("data", "model")), P(DP), P(DP, "model"),
         P(None, DP, "model"), P("model", DP), P(None, "model"),
         P(None, DP, "model", None, None), P("model", None), P("model")]
AXES = ["model", "data", ("data", "model")]


def _grid(dims):
    return make_grid(dims, ["cpu"] * 4)


def _shape(spec, rank_min=1):
    """A shape that ``spec`` divides on both grids, of the spec's rank."""
    n = max(len(spec), rank_min)
    return tuple(8 + 4 * i for i in range(n))


def _groups_np(dims, axes):
    """The groups over ``axes`` by a numpy index walk (the reference's
    device-grid order, first named axis major)."""
    names = ("data", "model")
    axes = spmd.axes_of(axes)
    idx = np.arange(4).reshape(dims)
    out = {}
    for p in range(4):
        at = np.unravel_index(p, dims)
        key = tuple(at[i] for i, a in enumerate(names) if a not in axes)
        out.setdefault(key, []).append(p)
    # order within a group: by the coordinate along ``axes``
    for key, members in out.items():
        members.sort(key=lambda p: tuple(
            np.unravel_index(p, dims)[names.index(a)] for a in axes))
    return [out[k] for k in sorted(out)]


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("axes", AXES)
def test_groups_follow_the_grid_order(dims, axes):
    assert spmd.groups(_grid(dims), axes) == _groups_np(dims, axes)


# ---------------------------------------------------------------------------
# place / gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_place_then_gather_is_the_identity(dims, spec):
    g = _grid(dims)
    x = torch.randn(_shape(spec), generator=torch.Generator().manual_seed(1))
    s = spmd.place(x, NamedSharding(g, spec))
    assert s.shape == tuple(x.shape) and len(s.blocks) == 4
    want = NamedSharding(g, spec).shard_shape(x.shape)
    assert all(tuple(b.shape) == want for b in s.blocks)
    assert torch.equal(spmd.gather(s), x)
    for p, blk in enumerate(s.blocks):
        assert torch.equal(blk, x[spmd.block_slices(s.sharding, x.shape, p)])
        # a view of the source, not a copy
        assert blk.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()


@pytest.mark.parametrize("dims", GRIDS)
def test_a_dimension_that_does_not_divide(dims):
    g = _grid(dims)
    x = torch.randn(7, 6)
    with pytest.raises(ValueError, match="does not divide"):
        spmd.place(x, NamedSharding(g, P(("data", "model"))))
    whole = spmd.place(x, NamedSharding(g, P()))
    assert torch.equal(spmd.gather(whole), x)
    # one replicated block shared by the places of one device
    assert all(b is whole.blocks[0] for b in whole.blocks)


def test_place_tree_round_trips_a_tree():
    g = _grid((2, 2))
    tree = {"a": torch.randn(4, 8), "b": {"c": torch.arange(12.)}}
    sh = {"a": NamedSharding(g, P(DP, "model")),
          "b": {"c": NamedSharding(g, P("model"))}}
    back = spmd.gather_tree(spmd.place_tree(tree, sh))
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"]["c"], tree["b"]["c"])


def test_place_on_an_abstract_grid_gives_one_meta_block():
    g = make_grid((16, 16))
    s = spmd.place(torch.empty(512, 64, device="meta"),
                   NamedSharding(g, P(("data", "model"))))
    assert len(s.blocks) == 1 and s.blocks[0].is_meta
    assert tuple(s.blocks[0].shape) == (2, 64)
    assert spmd.gather(s).shape == (512, 64)


# ---------------------------------------------------------------------------
# collectives against numpy loops in grid order
# ---------------------------------------------------------------------------

def _blocks(seed, shape, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype) for _ in range(4)]


def _np(x):
    return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
        else x.detach().numpy()


def _loop_sum(xs, members):
    acc = np.array(_np(xs[members[0]]), dtype=np.float32, copy=True)
    for m in members[1:]:
        acc = acc + _np(xs[m]).astype(np.float32)
    return acc


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("axes", AXES)
def test_all_gather_is_the_loop(dims, axes):
    g = _grid(dims)
    xs = _blocks(2, (3, 4))
    out = spmd.all_gather(xs, g, axes, dim=1)
    for members in _groups_np(dims, axes):
        want = np.concatenate([_np(xs[m]) for m in members], axis=1)
        for m in members:
            np.testing.assert_array_equal(_np(out[m]), want)


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("uneven", [False, True])
def test_reduce_scatter_is_the_loop(dims, axes, uneven):
    g = _grid(dims)
    k = spmd.axis_size(g, axes)
    n = 4 * k + (3 if uneven else 0)
    sizes = spmd.even_sizes(n, k) if uneven else None
    xs = _blocks(3, (n, 5))
    out = spmd.reduce_scatter(xs, g, axes, dim=0, sizes=sizes)
    parts = sizes or [n // k] * k
    for members in _groups_np(dims, axes):
        total = _loop_sum(xs, members)
        lo = 0
        for i, m in enumerate(members):
            np.testing.assert_array_equal(_np(out[m]),
                                          total[lo:lo + parts[i]])
            lo += parts[i]


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_all_reduce_is_the_loop(dims, axes, dtype):
    g = _grid(dims)
    xs = _blocks(4, (6, 7), dtype)
    out = spmd.all_reduce(xs, g, axes)
    for members in _groups_np(dims, axes):
        want = torch.from_numpy(_loop_sum(xs, members)).to(dtype)
        for m in members:
            assert out[m].dtype == dtype
            assert torch.equal(out[m], want)


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("axes", AXES)
def test_all_to_all_is_the_loop(dims, axes):
    g = _grid(dims)
    k = spmd.axis_size(g, axes)
    xs = _blocks(5, (2 * k, 3))
    out = spmd.all_to_all(xs, g, axes, split_dim=0, concat_dim=1)
    for members in _groups_np(dims, axes):
        for r, m_r in enumerate(members):
            want = np.concatenate([np.split(_np(xs[m]), k, axis=0)[r]
                                   for m in members], axis=1)
            np.testing.assert_array_equal(_np(out[m_r]), want)


@pytest.mark.parametrize("dims", GRIDS)
def test_fetch_pulls_ranges_from_their_holders(dims):
    g = _grid(dims)
    k = spmd.axis_size(g, "model")
    block = 6
    xs = _blocks(6, (2, block))
    # each place: the first half of its neighbour's block and a range
    # across a block edge
    want_at = []
    for p in range(4):
        c = spmd.coord(g, p, "model")
        nb = (c + 1) % k
        want_at.append([(nb * block, nb * block + 3),
                        (c * block + 4, min(k * block, c * block + 8))])
    spmd.reset_ledger()
    out = spmd.fetch(xs, g, "model", 1, block, want_at)
    for members in _groups_np(dims, "model"):
        whole = np.concatenate([_np(xs[m]) for m in members], axis=1)
        for m in members:
            want = np.concatenate([whole[:, a:b] for a, b in want_at[m]],
                                  axis=1)
            np.testing.assert_array_equal(_np(out[m]), want)
    led = spmd.ledger()
    if k == 1:
        assert led == {}
    else:
        # place 0 receives its neighbour's 3 columns and, past its own
        # block's edge, 2 more
        assert led == {"collective-permute": {"count": 1,
                                              "bytes": (3 + 2) * 2 * 4}}


# ---------------------------------------------------------------------------
# backward: the dual collective
# ---------------------------------------------------------------------------

def _vjp(fn, xs, cot):
    xs = [x.clone().requires_grad_() for x in xs]
    outs = fn(xs)
    torch.autograd.backward(outs, cot)
    return [x.grad for x in xs]


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter", "all_reduce",
                                "all_to_all"])
def test_backward_is_the_dual(dims, op):
    g = _grid(dims)
    axes = "model"
    k = spmd.axis_size(g, axes)
    xs = _blocks(7, (4 * k, 3))
    fwd = {"all_gather": lambda v: spmd.all_gather(v, g, axes, 0),
           "reduce_scatter": lambda v: spmd.reduce_scatter(v, g, axes, 0),
           "all_reduce": lambda v: spmd.all_reduce(v, g, axes),
           "all_to_all": lambda v: spmd.all_to_all(v, g, axes, 0, 1)}[op]
    shapes = [o.shape for o in fwd(xs)]
    gen = torch.Generator().manual_seed(8)
    cot = [torch.randn(s, generator=gen) for s in shapes]
    got = _vjp(fwd, xs, cot)
    dual = {"all_gather": lambda v: spmd.reduce_scatter(v, g, axes, 0),
            "reduce_scatter": lambda v: spmd.all_gather(v, g, axes, 0),
            "all_reduce": lambda v: spmd.all_reduce(v, g, axes),
            "all_to_all": lambda v: spmd.all_to_all(v, g, axes, 1, 0)}[op]
    for a, b in zip(got, dual(cot)):
        assert torch.equal(a, b)


def test_a_place_without_a_cotangent_gets_zeros_from_the_dual():
    g = _grid((2, 2))
    xs = [x.requires_grad_() for x in _blocks(9, (2, 2))]
    out = spmd.all_reduce(xs, g, "model")
    out[0].sum().backward()         # only place 0's output is used
    for m in (0, 1):
        assert torch.equal(xs[m].grad, torch.ones(2, 2))
    for m in (2, 3):                # the other group's sum is not used
        assert torch.equal(xs[m].grad, torch.zeros(2, 2))


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("axes", AXES)
def test_ledger_is_the_closed_form(dims, axes):
    g = _grid(dims)
    k = spmd.axis_size(g, axes)
    xs = _blocks(10, (4 * k, 3))
    spmd.reset_ledger()
    spmd.all_gather(xs, g, axes, 0)
    spmd.reduce_scatter(xs, g, axes, 0)
    spmd.reduce_scatter(xs, g, axes, 0)
    spmd.all_reduce(xs, g, axes)
    spmd.all_to_all(xs, g, axes, 0, 1)
    op = 4 * k * 3 * 4                   # one device's operand, float32
    want = {} if k == 1 else {
        "all-gather": {"count": 1, "bytes": op},
        "reduce-scatter": {"count": 2, "bytes": 2 * op},
        "all-reduce": {"count": 1, "bytes": op},
        "all-to-all": {"count": 1, "bytes": op}}
    assert spmd.ledger() == want


def test_the_backward_is_counted_too():
    g = _grid((2, 2))
    xs = [x.requires_grad_() for x in _blocks(11, (4, 3))]
    spmd.reset_ledger()
    out = spmd.all_gather(xs, g, "model", 0)
    torch.autograd.backward(out, [torch.ones_like(o) for o in out])
    assert spmd.ledger() == {"all-gather": {"count": 1, "bytes": 48},
                             "reduce-scatter": {"count": 1, "bytes": 96}}


@pytest.mark.parametrize("axes", AXES)
def test_an_abstract_grid_reckons_what_the_places_move(axes):
    real, abstract = _grid((2, 2)), make_grid((2, 2))
    k = spmd.axis_size(real, axes)
    ledgers, shapes = [], []
    for g, xs in ((real, _blocks(12, (4 * k, 3))),
                  (abstract, [torch.empty(4 * k, 3, device="meta")])):
        spmd.reset_ledger()
        outs = [spmd.all_gather(xs, g, axes, 0)[0],
                spmd.reduce_scatter(xs, g, axes, 0)[0],
                spmd.all_reduce(xs, g, axes)[0],
                spmd.all_to_all(xs, g, axes, 0, 1)[0],
                spmd.fetch(xs, g, axes, 0, 4 * k, [[(0, 4 * k + 1)]] * len(xs))[0]]
        shapes.append([tuple(o.shape) for o in outs])
        ledgers.append(spmd.ledger())
    assert shapes[0] == shapes[1]
    assert ledgers[0] == ledgers[1]


# ---------------------------------------------------------------------------
# lockstep
# ---------------------------------------------------------------------------

def test_lockstep_runs_each_place_to_its_end():
    g = _grid((2, 2))

    def prog(p):
        x = torch.full((2,), float(p))
        y = yield spmd.AllReduce(x, "model")
        z = yield spmd.AllGather(y, "data", 0)
        return z

    out = spmd.lockstep(g, [prog(p) for p in range(4)])
    for z in out:
        assert z.tolist() == [1.0, 1.0, 5.0, 5.0]


def test_lockstep_raises_where_places_disagree():
    g = _grid((2, 2))

    def prog(p):
        x = torch.zeros(2)
        if p == 3:
            yield spmd.AllReduce(x, "data")
        else:
            yield spmd.AllReduce(x, "model")
        return x

    with pytest.raises(RuntimeError, match="disagree"):
        spmd.lockstep(g, [prog(p) for p in range(4)])
