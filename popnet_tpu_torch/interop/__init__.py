from popnet_tpu_torch.interop.from_jax import load_into, load_npz, state_dict_from_jax

__all__ = ["load_into", "load_npz", "state_dict_from_jax"]
