// The f32-q unit of decode.cu (decode_body.cuh, DecodeQ): its builds for
// that q type over the float and fp8 caches (the int8-K ones in
// decode_f32_i8.cu), under the entry point cfa_decode_f32.
#define CFA_DECODE_F32 1
#define cfa_decode cfa_decode_f32
#include "decode.cu"
