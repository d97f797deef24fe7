// The int8-K unit of decode.cu for an fp16 q (decode_body.cuh, kI8Unit): its
// builds over int8 and int8-K / fp8-V caches, with and without an int8 Q,
// under the entry point cfa_decode_f16_i8; decode_f16.cu builds the other
// caches.
#define CFA_DECODE_F16 1
#define CFA_DECODE_I8 1
#define cfa_decode cfa_decode_f16_i8
#include "decode.cu"
