from automodel_tpu_torch.models.llama.model import LlamaForCausalLM
from automodel_tpu_torch.models.llama.state_dict_adapter import params_from_jax

__all__ = ["LlamaForCausalLM", "params_from_jax"]
