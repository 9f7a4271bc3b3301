"""PyTorch/CUDA port of automodel_tpu, slice by slice.

The package mirrors ``automodel_tpu``'s module paths so each module's
counterpart is found at the same place. It imports ``torch`` and never
``jax``, and nothing of ``automodel_tpu``: the JAX package is the reference
the port is held against in ``tests/test_torch_*.py``.

Ported so far, for the llama family: the serving path (``serve``), with the
paged-attention decode kernel (``csrc/paged_attention.cu``), and the SFT
training path (``finetune llm``, ``pretrain llm``), with the flash-attention
forward and backward kernels (``csrc/flash_attention.cu``); both kernels
are CUDA C++ for Hopper. Checkpoints and HF weights go in and out through
``checkpoint/`` (``from_pretrained``, DCP training states with resume,
consolidated HF saves, ``verify-ckpt``). Entry points run on CUDA unless the caller asks
for the CPU (``device: cpu``); there is no silent CPU fallback.
"""

from automodel_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
