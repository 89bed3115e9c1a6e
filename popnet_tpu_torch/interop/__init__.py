from popnet_tpu_torch.interop.from_jax import load_into, load_npz, state_dict_from_jax
from popnet_tpu_torch.interop.torch_import import (
    import_state_dict,
    load_torch_checkpoint,
    strip_module_prefix,
)

__all__ = ["import_state_dict", "load_into", "load_npz", "load_torch_checkpoint",
           "state_dict_from_jax", "strip_module_prefix"]
