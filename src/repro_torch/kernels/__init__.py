"""Hand-written CUDA kernels (``csrc/*.cu``), their ctypes wrappers and
plain torch versions, and the per-box kernel ledger."""
