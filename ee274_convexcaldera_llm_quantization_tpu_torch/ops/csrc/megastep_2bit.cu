// The whole-step decode megakernel (megastep.cuh) for 2-bit codes: a library
// of its own, so that it builds in parallel with the 4-bit one.
#include "megastep.cuh"

MEGASTEP_ENTRIES(2)
