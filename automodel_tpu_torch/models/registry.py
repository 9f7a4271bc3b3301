"""HF architecture → the port's model family.

Port of ``automodel_tpu/models/registry.py`` for the families the port
has: ``LlamaForCausalLM`` and the dense architectures JAX sends to the
same builder (:46-53): ``Qwen2ForCausalLM`` (attention biases),
``Qwen3ForCausalLM`` (per-head q/k norms), ``MistralForCausalLM`` (the
sliding window) and ``Phi3ForCausalLM`` (partial rotary; its fused
``qkv_proj`` / ``gate_up_proj`` checkpoints load through
checkpoint/conversion_mapping.py); ``Qwen3MoeForCausalLM`` (the MoE family of
``models/qwen3_moe``, registered at :130 of the JAX registry) and the
architectures JAX sends to the same builder (:130-151):
``Glm4MoeForCausalLM``, ``MixtralForCausalLM`` and ``Qwen2MoeForCausalLM``
(the last two save in their own HF key dialect), ``DeepseekV3ForCausalLM``
(``models/deepseek_v3``, :92-103),
``GptOssForCausalLM`` (``models/gpt_oss``, :106) and
``Gemma2ForCausalLM`` / ``Gemma3ForCausalLM`` (``models/gemma``, :70). A
config naming another architecture (``Gemma3ForConditionalGeneration``,
the vision-language Gemma 3, among them) is refused; a config naming none
builds the generic llama, as in the JAX registry.
"""

from __future__ import annotations

from typing import Any, Callable

from automodel_tpu_torch.models.common.config import BackendConfig, TransformerConfig

_REGISTRY: dict[str, Callable] = {}


def register_architecture(*names: str):
    def deco(builder: Callable):
        for n in names:
            _REGISTRY[n] = builder
        return builder

    return deco


@register_architecture(
    "LlamaForCausalLM", "Qwen2ForCausalLM", "Qwen3ForCausalLM", "MistralForCausalLM", "Phi3ForCausalLM"
)
def _llama_builder(hf_config: Any, backend: BackendConfig, device=None, trainable: bool = False):
    from automodel_tpu_torch.models.llama import LlamaForCausalLM

    return LlamaForCausalLM(TransformerConfig.from_hf(hf_config), backend, device=device, trainable=trainable)


@register_architecture("Qwen3MoeForCausalLM", "Glm4MoeForCausalLM", "MixtralForCausalLM", "Qwen2MoeForCausalLM")
def _moe_builder(hf_config: Any, backend: BackendConfig, device=None, trainable: bool = False):
    from automodel_tpu_torch.models.qwen3_moe import MoEForCausalLM, MoETransformerConfig
    from automodel_tpu_torch.models.qwen3_moe.model import hf_key_style

    model = MoEForCausalLM(MoETransformerConfig.from_hf(hf_config), backend, device=device, trainable=trainable)
    model.hf_key_style = hf_key_style(hf_config)
    return model


@register_architecture("DeepseekV3ForCausalLM")
def _deepseek_v3_builder(hf_config: Any, backend: BackendConfig, device=None, trainable: bool = False):
    from automodel_tpu_torch.models.deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM

    return DeepseekV3ForCausalLM(DeepseekV3Config.from_hf(hf_config), backend, device=device, trainable=trainable)


@register_architecture("GptOssForCausalLM")
def _gpt_oss_builder(hf_config: Any, backend: BackendConfig, device=None, trainable: bool = False):
    from automodel_tpu_torch.models.gpt_oss import GptOssConfig, GptOssForCausalLM

    return GptOssForCausalLM(GptOssConfig.from_hf(hf_config), backend, device=device, trainable=trainable)


@register_architecture("Gemma2ForCausalLM", "Gemma3ForCausalLM")
def _gemma_builder(hf_config: Any, backend: BackendConfig, device=None, trainable: bool = False):
    from automodel_tpu_torch.models.gemma import GemmaConfig, GemmaForCausalLM

    return GemmaForCausalLM(GemmaConfig.from_hf(hf_config), backend, device=device, trainable=trainable)


def resolve_architecture(hf_config: Any) -> Callable:
    archs = (
        hf_config.get("architectures")
        if isinstance(hf_config, dict)
        else getattr(hf_config, "architectures", None)
    ) or []
    if not archs:
        return _llama_builder
    for a in archs:
        if a in _REGISTRY:
            return _REGISTRY[a]
    raise ValueError(
        f"architectures {list(archs)} are not ported to the torch backend "
        f"(it has {available_architectures()})"
    )


def available_architectures() -> list[str]:
    return sorted(_REGISTRY)
