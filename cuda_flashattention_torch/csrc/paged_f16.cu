// The f16-q unit of paged.cu (decode_body.cuh, DecodeQ): its builds
// for that q type, under the entry point cfa_paged_decode_f16.
#define CFA_DECODE_F16 1
#define cfa_paged_decode cfa_paged_decode_f16
#include "paged.cu"
