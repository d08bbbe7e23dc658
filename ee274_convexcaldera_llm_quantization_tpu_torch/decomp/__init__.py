"""The CALDERA decomposition ``W ~= Q + L @ R`` and its low-rank helpers."""
