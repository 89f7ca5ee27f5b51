// The logit pair delta at a warps-a-block count the call chooses (1, 2, 4 or
// 8): the kernels of logit_delta.cu with the block's size read at run time,
// behind the entry point logit_pair_delta_warps. Its own source, so nvcc
// builds it beside the default launch's library, in parallel; see the
// "Launch parameter" note in logit_delta.cu.
#define PAIR_DELTA_ANY_WARPS
#include "logit_delta.cu"
