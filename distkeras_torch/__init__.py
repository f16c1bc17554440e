"""distkeras_torch: the PyTorch / CUDA port of distkeras_tpu.

The first slice covers TransformerLM serving: KV-cache generation with the
fused decode-step kernel and the flash-attention forward for scoring.
Entry points run on the CUDA card unless a caller passes ``device="cpu"``.
Imports PyTorch, numpy and the standard library only.
"""

from distkeras_torch.models.base import Model, ModelSpec
from distkeras_torch.models.decode import generate, make_generate_fn
from distkeras_torch.models.transformer import small_lm_spec

__all__ = ["Model", "ModelSpec", "small_lm_spec", "make_generate_fn", "generate"]
