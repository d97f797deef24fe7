// The int8-K unit of paged.cu for an fp32 q (decode_body.cuh, kI8Unit): its
// builds over int8 and int8-K / fp8-V caches, with and without an int8 Q,
// under the entry point cfa_paged_decode_f32_i8; paged_f32.cu builds the
// other caches.
#define CFA_DECODE_F32 1
#define CFA_DECODE_I8 1
#define cfa_paged_decode cfa_paged_decode_f32_i8
#include "paged.cu"
