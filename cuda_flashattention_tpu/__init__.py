"""cuda_flashattention_tpu — an attention framework in JAX for the GPU.

A from-scratch JAX/XLA/Pallas design of the capabilities of the CUDA
reference ladder (terryye/cuda_FlashAttention): exact-attention golden
oracle, FlashAttention-2 forward + backward as Pallas kernels on the
Triton route, quantized (FP8/INT8) KV caches with dequant fused into the
kernels, and ring (sequence-parallel) attention over a
`jax.sharding.Mesh` using `jax.lax.ppermute` instead of MPI/NCCL.

Layer map (mirrors SURVEY.md §1):

  L0 oracle      ops.naive              (ref: src/util/naive_attention.h)
  L1 helpers     utils.testing, ops.common
                                        (ref: src/util/{cuda,attention}_helper.h)
  L2 kernels     ops.flash_fwd, ops.flash_bwd, ops.decode, ops.quant
                                        (ref: src/02_*/**.cu)
  L3 host API    ops.attention (custom_vjp), ops.decode
                                        (ref: host wrappers in *.cu)
  L4 distributed parallel.ring, parallel.mesh
                                        (ref: src/util/nccl_utils.h, 03_*/)
  L5 tests       tests/ (pytest ladder) (ref: per-stage self-verifying mains)
  L6 launch      scripts/, examples/    (ref: scripts/, run.sh)
"""

__version__ = "0.1.0"

from cuda_flashattention_tpu.ops.attention import flash_attention, mha
from cuda_flashattention_tpu.ops.decode import decode_attention
from cuda_flashattention_tpu.ops.kv_cache import (
    KVCache,
    append,
    decode_step,
    init_cache,
)
from cuda_flashattention_tpu.ops.paged import (
    PageAllocator,
    PagedKVCache,
    init_paged_cache,
    paged_append,
    paged_decode_attention,
    paged_decode_step,
)
from cuda_flashattention_tpu.ops.naive import (
    naive_attention,
    naive_attention_backward,
)
from cuda_flashattention_tpu.ops.quant import (
    QuantizedKV,
    flash_attention_quantized,
    quantize_kv,
)

__all__ = [
    "flash_attention",
    "mha",
    "decode_attention",
    "paged_decode_attention",
    "PagedKVCache",
    "PageAllocator",
    "init_paged_cache",
    "paged_append",
    "paged_decode_step",
    "KVCache",
    "append",
    "decode_step",
    "init_cache",
    "naive_attention",
    "naive_attention_backward",
    "QuantizedKV",
    "flash_attention_quantized",
    "quantize_kv",
    "__version__",
]
