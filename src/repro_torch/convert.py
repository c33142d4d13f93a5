"""State carried across from the reference engines into the port.

There are no weights: the state of a triangle engine is its oriented CSR
and its box plan, and that of a query engine its query, its relations and
its plan. ``engine_from_state`` and ``query_engine_from_state`` take them
as plain Python and numpy values and return a port engine that runs
exactly that CSR and that plan, so a lane-by-lane comparison with the
reference is not confounded by planning.

``engine_from_state`` keys: ``indptr`` (V+1 int64), ``indices`` (int32),
``orientation`` ('minmax' or 'degree'), ``nv`` (V), ``plan`` (a list of
``(lx, hx, ly, hy)``; optional — without it the port plans for itself) and
``lanes`` (optional, with ``plan`` only: the reference's per-box
``'hub'`` / ``'light'`` / ``'mixed'`` class of a ``skew='heavy_light'``
plan, so the carried-across plan routes box for box as it does there).

``query_engine_from_state`` keys: ``head`` (variable names), ``atoms``
(``(relation, (var, var))`` pairs), ``relations`` (name -> ``{"indptr",
"indices", "orientation"}``: the reference engine's sources), ``order``,
``rank``, ``boxes`` (per box, one inclusive ``(lo, hi)`` per variable),
``lanes`` (per box, or empty), ``skew``, ``heavy_threshold``, ``budgets``
and ``single_box`` (optional: the planner's per-dimension budget split)
and ``mem_words`` (the budget the plan was cut for; ``kw`` may not
override it, or the port would plan anew).

A model's state is its params: ``params_from_reference`` takes the
reference's materialized params (DLRM's, a GNN's or an LM's) as a tree of
numpy arrays (``np.asarray`` of each; a GNN's and an LM's nest dicts, an
LM's ``block{i}`` stacked along a leading layer axis) and returns the
port's tensors in the same tree with the same bits, bfloat16 included.
An LM's KV cache goes across the same way (``cache_from_reference``). A training run's state adds the optimizer's:
``opt_state_from_reference`` carries the reference's ``OptState`` (step,
and the float32 moments m and v in the params' tree) across the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.engine import TriangleEngine
from repro_torch.core.leapfrog import Atom
from repro_torch.core.queries import Query
from repro_torch.data.edgestore import InMemoryEdgeSource
from repro_torch.optim.adamw import OptState
from repro_torch.pytree import tree_map
from repro_torch.query.executor import QueryEngine
from repro_torch.query.planner import QueryPlan


def engine_from_state(state: Mapping, **kw) -> TriangleEngine:
    """A port ``TriangleEngine`` over ``state`` (see the module docstring);
    ``kw`` are engine options (``torch_device``, ``backend``, ``mem_words``,
    ``workers``, ...)."""
    indptr = np.asarray(state["indptr"], dtype=np.int64)
    if int(state["nv"]) != len(indptr) - 1:
        raise ValueError(f"state nv={state['nv']} disagrees with indptr "
                         f"({len(indptr) - 1} rows)")
    eng = TriangleEngine(csr=(indptr, np.asarray(state["indices"])),
                         orientation=state["orientation"], **kw)
    plan = state.get("plan")
    lanes = state.get("lanes")
    if lanes is not None and plan is None:
        raise ValueError("state 'lanes' needs the 'plan' they classify")
    if plan is not None:
        boxes = [tuple(int(x) for x in box) for box in plan]
        eng._plan_cache = (eng.mem_words, boxes)
        if lanes is not None:
            if len(lanes) != len(boxes):
                raise ValueError(f"state has {len(lanes)} lanes for "
                                 f"{len(boxes)} boxes")
            eng._box_lane = dict(zip(boxes, (str(x) for x in lanes)))
    return eng


def query_engine_from_state(state: Mapping, **kw) -> QueryEngine:
    """A port ``QueryEngine`` running the reference plan in ``state`` (see
    the module docstring); ``kw`` are engine options (``torch_device``,
    ``backend``, ``workers``, ``use_kernels``, ...)."""
    if "mem_words" in kw and kw["mem_words"] != state["mem_words"]:
        raise ValueError(f"mem_words={kw['mem_words']} differs from the "
                         f"plan's budget {state['mem_words']}")
    kw.pop("mem_words", None)
    query = Query(head=tuple(state["head"]),
                  atoms=[Atom(rel, tuple(vs)) for rel, vs in state["atoms"]])
    relations = {
        name: InMemoryEdgeSource(np.asarray(r["indptr"], dtype=np.int64),
                                 np.asarray(r["indices"], dtype=np.int32),
                                 orientation=r["orientation"])
        for name, r in state["relations"].items()}
    order = tuple(state["order"])
    boxes = [tuple((int(lo), int(hi)) for lo, hi in box)
             for box in state["boxes"]]
    lanes = [str(x) for x in state.get("lanes", [])]
    if lanes and len(lanes) != len(boxes):
        raise ValueError(f"state has {len(lanes)} lanes for {len(boxes)} "
                         "boxes")
    pos = {v: i for i, v in enumerate(order)}
    # an atom is owned by the dimension of its earlier variable in the
    # order (an inconsistent atom runs on its reversed index)
    owned = tuple(sorted({min(pos[v] for v in a.vars)
                          for a in query.atoms}))
    plan = QueryPlan(order=order, rank=int(state["rank"]),
                     owned_dims=owned, boxes=boxes,
                     budgets={int(d): int(b) for d, b
                              in state.get("budgets", {}).items()},
                     single_box=bool(state.get("single_box",
                                               len(boxes) <= 1)),
                     skew=str(state.get("skew", "uniform")), lanes=lanes,
                     heavy_threshold=int(state.get("heavy_threshold", 0)))
    return QueryEngine(query, relations=relations, order=order,
                       mem_words=state["mem_words"],
                       skew=plan.skew, plan=plan, **kw)


def _tensor_from_reference(value, device) -> torch.Tensor:
    """One reference array (numpy, or anything ``np.asarray`` takes) as a
    port tensor on ``device``, bit for bit. A bfloat16 array (numpy's
    ``ml_dtypes.bfloat16``, which torch cannot read) goes across as its
    bits: viewed as uint16, then ``torch.from_numpy``, then viewed as
    ``torch.bfloat16``."""
    arr = np.array(value)    # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _tree_from_reference(tree, device="cpu"):
    """A tree of reference arrays (nested dicts, lists, tuples) as the same
    tree of port tensors on ``device``, each leaf bit for bit
    (``_tensor_from_reference``)."""
    return tree_map(lambda v: _tensor_from_reference(v, device), tree)


def params_from_reference(tree: Mapping, device="cpu") -> Dict[str, Any]:
    """A reference model's params as port tensors on ``device`` in the same
    tree, bit for bit: DLRM's flat name -> array dict (bfloat16 tables
    included), a GNN's nested dicts of float32 arrays (GIN's
    ``layer<i>``, SchNet's ``inter<i>``, GraphCast's stacked ``proc``) or
    an LM's (``embed``, ``prefix<i>``, ``block<i>`` with its params
    stacked along a leading layer axis, ``attn`` / ``ffn`` subtrees;
    bfloat16 or float32 as the reference's ``set_dtypes`` made them)."""
    return _tree_from_reference(dict(tree), device)


def cache_from_reference(tree: Mapping, device="cpu") -> Dict[str, Any]:
    """A reference LM's KV cache (``prefix<i>`` / ``block<i>`` -> ``k``,
    ``v`` or MLA's ``latent``, ``rope``; the blocks' stacked along a
    leading layer axis) as port tensors on ``device``, bit for bit. The
    port's ``decode_step`` writes into the cache it is given."""
    return _tree_from_reference(dict(tree), device)


def opt_state_from_reference(state, device="cpu") -> OptState:
    """The reference's ``adamw.OptState`` (``step``, and ``m`` and ``v``
    in the params' tree; numpy, or anything ``np.asarray`` takes) as the
    port's ``OptState`` on ``device``, bit for bit: step an int32 0-d
    tensor, the moments float32, nested as the params are."""
    return OptState(
        step=torch.from_numpy(np.array(state.step, dtype=np.int32))
        .to(device),
        m=_tree_from_reference(state.m, device),
        v=_tree_from_reference(state.v, device))
