"""Checkpoints in the reference's on-disk format (``ckpt``)."""
