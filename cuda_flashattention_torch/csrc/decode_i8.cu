// The int8-K unit of decode.cu for a bf16 q (decode_body.cuh, kI8Unit): its
// builds over int8 and int8-K / fp8-V caches, with and without an int8 Q,
// under the entry point cfa_decode_i8; decode.cu builds the other caches.
#define CFA_DECODE_I8 1
#define cfa_decode cfa_decode_i8
#include "decode.cu"
