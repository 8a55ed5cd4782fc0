"""Host-side utilities: CLI flags, checkpoints, NIfTI I/O."""
