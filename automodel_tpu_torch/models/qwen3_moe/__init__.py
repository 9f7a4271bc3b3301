from automodel_tpu_torch.models.qwen3_moe.model import MoEForCausalLM, MoEModelAux, MoETransformerConfig
from automodel_tpu_torch.models.qwen3_moe.state_dict_adapter import params_from_jax

__all__ = ["MoEForCausalLM", "MoEModelAux", "MoETransformerConfig", "params_from_jax"]
