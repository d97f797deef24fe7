"""cuda_flashattention_torch — the PyTorch + CUDA (Hopper) port of
cuda_flashattention_tpu.

Module names mirror the JAX package, which stays the reference that this
package is tested against. Attention runs through hand-written CUDA C++
kernels for sm_90a (csrc/), built by nvcc at first use on the card
(_build.py); on CPU tensors each op runs its plain PyTorch version.

Ported so far: the serving path — prefill (FA2 forward) and decode over
the KV cache (bf16, int8, fp8 or mixed; windows; integer Q·Kᵀ), driven by
`generate()`; paged serving (page pools, block tables, the host-side
`PageAllocator`, the paged decode kernel); the training path: `forward`,
`loss_fn` and `make_train_step`, with attention through the
differentiable `flash_attention` (FA2 forward, and the FA2 backward
kernels: fused, or split into dK/dV and dQ); and the FlashAttention-1
rung (`fa1_attention`).
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
from cuda_flashattention_torch.parallel.ring import combine_partials
from cuda_flashattention_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    decode_one,
    forward,
    init_caches,
    loss_fn,
    make_train_step,
    prefill,
    prefill_chunk,
    prefill_chunked,
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
    "kv_cache_from_numpy",
    "paged_cache_from_numpy",
    "params_from_jax",
    "params_to_jax",
    "generate",
    "cuda_time_ms",
]
