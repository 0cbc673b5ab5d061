"""Checkpoint-side transforms of the port (the int8 weight envelope)."""
