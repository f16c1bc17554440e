"""distkeras_torch: the PyTorch / CUDA port of distkeras_tpu.

Two slices so far: TransformerLM serving (KV-cache generation with the
fused decode-step kernel, the flash-attention forward for scoring) and
TransformerLM training on one device (the flash-attention backward kernels,
the fused unembed + CE loss, optax-style optimizers, ``make_lm_train_step``).
Entry points run on the CUDA card unless a caller passes ``device="cpu"``.
Imports PyTorch, numpy and the standard library only.
"""

from distkeras_torch.models.base import Model, ModelSpec
from distkeras_torch.models.decode import generate, make_generate_fn
from distkeras_torch.models.transformer import small_lm_spec
from distkeras_torch.parallel.lm import make_lm_train_step, shift_targets

__all__ = ["Model", "ModelSpec", "small_lm_spec", "make_generate_fn", "generate",
           "make_lm_train_step", "shift_targets"]
