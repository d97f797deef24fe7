// The fp16 unit of device_ring.cu: its 2-byte builds with fp16 elements
// (flash_fwd_bound_sm90.cuh, CFA_F16), under entry points named _f16.
#define CFA_F16 1
#define cfa_device_ring cfa_device_ring_f16
#define cfa_device_ring_resident cfa_device_ring_resident_f16
// (its copies of the workspace helpers, unbound: the bf16 unit's serve)
#define cfa_enable_peer_access cfa_enable_peer_access_f16
#define cfa_ipc_alloc cfa_ipc_alloc_f16
#define cfa_ipc_open cfa_ipc_open_f16
#define cfa_ipc_close cfa_ipc_close_f16
#define cfa_ipc_free cfa_ipc_free_f16
#include "device_ring.cu"
