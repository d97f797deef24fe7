// The fp16 unit of fa1.cu: its 2-byte builds with fp16 elements
// (flash_fwd_bound_sm90.cuh, CFA_F16), under entry points named _f16.
#define CFA_F16 1
#define cfa_fa1 cfa_fa1_f16
#include "fa1.cu"
