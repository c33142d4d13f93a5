"""Launch helpers of the multi-device tier (``mesh``)."""
