from automodel_tpu_torch.models.deepseek_v3.model import DeepseekV3Config, DeepseekV3ForCausalLM
from automodel_tpu_torch.models.deepseek_v3.state_dict_adapter import params_from_jax

__all__ = ["DeepseekV3Config", "DeepseekV3ForCausalLM", "params_from_jax"]
