from automodel_tpu_torch.models.gemma.model import GemmaConfig, GemmaForCausalLM
from automodel_tpu_torch.models.gemma.state_dict_adapter import params_from_jax

__all__ = ["GemmaConfig", "GemmaForCausalLM", "params_from_jax"]
