// The fp16 unit of flash_bwd.cu: its 2-byte builds with fp16 elements
// (flash_fwd_bound_sm90.cuh, CFA_F16), under entry points named _f16.
#define CFA_F16 1
#define cfa_flash_bwd_q cfa_flash_bwd_q_f16
#include "flash_bwd.cu"
