"""Bit allocation: Convex-CALDERA's certified single-group solve
(``convex``) and budgeted allocation over groups (``multigroup``)."""
