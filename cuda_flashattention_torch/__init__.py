"""cuda_flashattention_torch — the PyTorch + CUDA (Hopper) port of
cuda_flashattention_tpu.

Module names mirror the JAX package, which stays the reference that this
package is tested against. Attention runs through hand-written CUDA C++
kernels for sm_90a (csrc/), built by nvcc at first use on the card
(_build.py); on CPU tensors each op runs its plain PyTorch version.

Ported so far: the serving path — prefill (FA2 forward) and decode over
the KV cache, driven by `generate()`.
"""

__version__ = "0.1.0"

from cuda_flashattention_torch.ops.common import NEG_INF
from cuda_flashattention_torch.ops.decode import (
    decode_attention,
    decode_attention_plain,
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
from cuda_flashattention_torch.ops.naive import naive_attention, naive_decode
from cuda_flashattention_torch.parallel.ring import combine_partials
from cuda_flashattention_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    decode_one,
    init_caches,
    prefill,
    prefill_chunk,
    prefill_chunked,
)
from cuda_flashattention_torch.models.convert import params_from_jax
from cuda_flashattention_torch.models.generate import generate
from cuda_flashattention_torch.utils.timing import cuda_time_ms

__all__ = [
    "NEG_INF",
    "decode_attention",
    "decode_attention_plain",
    "flash_attention_forward",
    "flash_attention_forward_plain",
    "KVCache",
    "append",
    "decode_step",
    "init_cache",
    "naive_attention",
    "naive_decode",
    "combine_partials",
    "Transformer",
    "TransformerConfig",
    "decode_one",
    "init_caches",
    "prefill",
    "prefill_chunk",
    "prefill_chunked",
    "params_from_jax",
    "generate",
    "cuda_time_ms",
]
