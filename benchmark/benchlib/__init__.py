"""The benchmark's harness (``benchmark/run.py``): the cell's files, the
seeded weights, the two modes a traffic mix names (``train``, ``rollout``),
the trace reduction, the frozen work counts and the comparison that
decides ``correct``."""
