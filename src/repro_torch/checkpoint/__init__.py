"""Asynchronous disk checkpoints (the reference's checkpoint/)."""
