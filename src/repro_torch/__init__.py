"""PyTorch/CUDA port of the boxed Leapfrog-Triejoin triangle engine.

Runs ``TriangleEngine.count()`` / ``.list()`` on an in-memory graph on an
NVIDIA card, with hand-written CUDA kernels for the intersect and dense
lanes (``kernels/``). It imports ``torch`` and numpy only. Entry points run
on the card unless the caller passes ``torch_device="cpu"``.
"""

from repro_torch.core.engine import (EngineStats, TriangleEngine,
                                     engine_count, engine_list)

__all__ = ["EngineStats", "TriangleEngine", "engine_count", "engine_list"]
