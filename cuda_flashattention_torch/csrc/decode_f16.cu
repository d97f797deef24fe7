// The f16-q unit of decode.cu (decode_body.cuh, DecodeQ): its builds for
// that q type over the float and fp8 caches (the int8-K ones in
// decode_f16_i8.cu), under the entry point cfa_decode_f16.
#define CFA_DECODE_F16 1
#define cfa_decode cfa_decode_f16
#include "decode.cu"
