"""Data parallelism: the process group, the mesh and its row rule, and the
collectives that make a sharded step equal the one-process step."""
