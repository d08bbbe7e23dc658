// The whole-step decode megakernel (megastep.cuh) for 4-bit codes.
#include "megastep.cuh"

MEGASTEP_ENTRIES(4)
