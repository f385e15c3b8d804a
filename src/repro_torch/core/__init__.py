"""nSimplex math: metrics, base simplex + apex projection, estimators."""
