"""State carried across from the reference engine into the port.

There are no weights: the state of a triangle engine is its oriented CSR
and its box plan. ``engine_from_state`` takes them as plain numpy values
and returns a port engine that runs exactly that CSR and that plan, so a
lane-by-lane comparison with the reference is not confounded by planning.

``state`` keys: ``indptr`` (V+1 int64), ``indices`` (int32), ``orientation``
('minmax' or 'degree'), ``nv`` (V), ``plan`` (a list of
``(lx, hx, ly, hy)``; optional — without it the port plans for itself) and
``lanes`` (optional, with ``plan`` only: the reference's per-box
``'hub'`` / ``'light'`` / ``'mixed'`` class of a ``skew='heavy_light'``
plan, so the carried-across plan routes box for box as it does there).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.core.engine import TriangleEngine


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
