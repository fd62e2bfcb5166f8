"""Hand-written CUDA kernels for the serving hot path, each beside its
plain PyTorch version.

The same names as the JAX package's ``ops``: flash attention (the prefill
attention, O(S*D) bytes instead of materialized scores) and paged decode
attention (block-table gather, int8 dequant and attention fused over the
paged KV pool).  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel, built from ``csrc/`` at first use.
"""

from seldon_core_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_causal_attention_blhd,
)
from seldon_core_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)

# the JAX package's name for the plain read side
paged_decode_attention_reference = paged_decode_attention_plain

__all__ = [
    "flash_attention",
    "flash_causal_attention_blhd",
    "paged_decode_attention",
    "paged_decode_attention_reference",
]
