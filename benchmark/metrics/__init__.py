"""Per-layer metrics: one reader per metric, found by its name."""
