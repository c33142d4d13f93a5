"""Checkpoints of the port (``manager``: the reference's layout)."""
