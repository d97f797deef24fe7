"""cuda_flashattention_torch — the PyTorch + CUDA (Hopper) port of
cuda_flashattention_tpu.

Module names mirror the JAX package, which stays the reference that this
package is tested against. Attention runs through hand-written CUDA C++
kernels for sm_90a (csrc/), built by nvcc at first use on the card
(_build.py); on CPU tensors each op runs its plain PyTorch version.

Ported so far: the serving path — prefill, whole or chunked (the FA2
forward in all its forms: online, score-bound and K-major softmax,
sliding windows, segment ids, int8 / fp8 / mixed K/V, integer Q·Kᵀ) and
decode over the KV cache (bf16, int8, fp8 or mixed; windows; integer
Q·Kᵀ), driven by `generate()`; `flash_attention_quantized`; the
sliding-window model in serving and training; paged serving (page pools, block tables, the host-side
`PageAllocator`, the paged decode kernel); the training path: `forward`,
`loss_fn` and `make_train_step`, with attention through the
differentiable `flash_attention` (FA2 forward, and the FA2 backward
kernels: fused, or split into dK/dV and dQ); the FlashAttention-1
rung (`fa1_attention`); and the distributed layer, single-controller as
the JAX package's: a `Mesh` of devices that may repeat (N ranks on one
card, each with its own streams), `ring_attention` (forward and backward;
`ring_attention_local` over shards that stay on their ranks), the
collectives GSPMD inserts (`parallel/collectives.py`), `ring_decode`,
`ulysses_attention`, `gpipe_spmd`, the model's sequence-, data- and
tensor-parallel forms, each layer computed on the ranks from the weight
slices `shard_model` places, and its pipelined form, and the
device-initiated ring (`device_ring_matmul`, kernel K9).
"""

__version__ = "0.1.0"

from cuda_flashattention_torch.ops.attention import (
    FlashAttention,
    flash_attention,
    mha,
)
from cuda_flashattention_torch.ops.common import NEG_INF
from cuda_flashattention_torch.ops.fa1 import (
    fa1_attention,
    fa1_attention_plain,
)
from cuda_flashattention_torch.ops.decode import (
    decode_attention,
    decode_attention_plain,
)
from cuda_flashattention_torch.ops.flash_bwd import (
    flash_attention_backward,
    flash_attention_backward_plain,
)
from cuda_flashattention_torch.ops.flash_fwd import (
    flash_attention_forward,
    flash_attention_forward_plain,
)
from cuda_flashattention_torch.ops.kv_cache import (
    KVCache,
    append,
    decode_step,
    init_cache,
)
from cuda_flashattention_torch.ops.paged import (
    PageAllocator,
    PagedKVCache,
    init_paged_cache,
    paged_append,
    paged_bulk_append,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_step,
    paged_prefix_attention,
)
from cuda_flashattention_torch.ops.naive import (
    naive_attention,
    naive_attention_backward,
    naive_decode,
)
from cuda_flashattention_torch.ops.quant import (
    QuantizedKV,
    flash_attention_quantized,
    quantize_kv,
    quantize_tensor,
)
from cuda_flashattention_torch.parallel.device_ring import (
    device_ring_matmul,
    ring_matmul_plain,
)
from cuda_flashattention_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_mesh,
    sequence_mesh,
    shard_on_axis,
)
from cuda_flashattention_torch.parallel.pipeline import (
    gpipe_spmd,
    stack_stage_params,
    stage_param_sharding,
)
from cuda_flashattention_torch.parallel.ring import (
    combine_partials,
    ring_attention,
    ring_attention_local,
    ring_decode,
    ring_decode_local,
)
from cuda_flashattention_torch.parallel.ulysses import ulysses_attention
from cuda_flashattention_torch.models.transformer import (
    ShardedTransformer,
    Transformer,
    TransformerConfig,
    decode_one,
    forward,
    gather_model,
    init_caches,
    layer_weights,
    loss_fn,
    make_train_step,
    param_shardings,
    pipeline_forward,
    prefill,
    prefill_chunk,
    prefill_chunked,
    shard_model,
    shard_param,
)
from cuda_flashattention_torch.models.convert import (
    kv_cache_from_numpy,
    paged_cache_from_numpy,
    params_from_jax,
    params_to_jax,
)
from cuda_flashattention_torch.models.generate import generate
from cuda_flashattention_torch.utils.timing import cuda_time_ms

__all__ = [
    "FlashAttention",
    "flash_attention",
    "mha",
    "NEG_INF",
    "fa1_attention",
    "fa1_attention_plain",
    "decode_attention",
    "decode_attention_plain",
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "PagedKVCache",
    "PageAllocator",
    "init_paged_cache",
    "paged_append",
    "paged_bulk_append",
    "paged_decode_step",
    "paged_prefix_attention",
    "flash_attention_backward",
    "flash_attention_backward_plain",
    "flash_attention_forward",
    "flash_attention_forward_plain",
    "KVCache",
    "append",
    "decode_step",
    "init_cache",
    "naive_attention",
    "naive_attention_backward",
    "naive_decode",
    "QuantizedKV",
    "flash_attention_quantized",
    "quantize_kv",
    "quantize_tensor",
    "combine_partials",
    "ring_attention",
    "ring_attention_local",
    "ring_decode",
    "ring_decode_local",
    "ulysses_attention",
    "gpipe_spmd",
    "stack_stage_params",
    "stage_param_sharding",
    "device_ring_matmul",
    "ring_matmul_plain",
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "sequence_mesh",
    "shard_on_axis",
    "Transformer",
    "TransformerConfig",
    "decode_one",
    "forward",
    "init_caches",
    "loss_fn",
    "make_train_step",
    "prefill",
    "prefill_chunk",
    "prefill_chunked",
    "layer_weights",
    "param_shardings",
    "pipeline_forward",
    "shard_param",
    "shard_model",
    "gather_model",
    "ShardedTransformer",
    "kv_cache_from_numpy",
    "paged_cache_from_numpy",
    "params_from_jax",
    "params_to_jax",
    "generate",
    "cuda_time_ms",
]
