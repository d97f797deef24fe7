// The fp16 unit of flash_bwd_kv.cu: its 2-byte builds with fp16 elements
// (flash_fwd_bound_sm90.cuh, CFA_F16), under entry points named _f16.
#define CFA_F16 1
#define cfa_flash_bwd_kv cfa_flash_bwd_kv_f16
#include "flash_bwd_kv.cu"
