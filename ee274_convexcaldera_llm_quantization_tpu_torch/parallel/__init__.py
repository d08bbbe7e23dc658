"""Parallelism: the process-group bootstrap and a local launcher, the
(dp, tp) device mesh and its DTensor catalog, tensor-parallel kernels and
steps (stacked and fused, slotted and paged), pipeline-parallel decode,
and the collectives they share."""
