// The f16-q unit of paged.cu (decode_body.cuh, DecodeQ): its builds for
// that q type over the float and fp8 caches (the int8-K ones in
// paged_f16_i8.cu), under the entry point cfa_paged_decode_f16.
#define CFA_DECODE_F16 1
#define cfa_paged_decode cfa_paged_decode_f16
#include "paged.cu"
