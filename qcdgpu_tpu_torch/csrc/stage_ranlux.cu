// K1 drawing from the PRNGCL ranlux streams (ranlux0-4: the luxury level is
// the run-time skip length): heat-bath and Metropolis, SU(3) and
// SU(2), tracked or not.  Kernel in stage.cuh, generator in streams.cuh.
#include "streams.cuh"

QG_DEFINE_STREAM_LAUNCHER(ranlux, Ranlux<false>)
