from deepfluoro_tpu_torch.compat.from_jax import fold_state_dict_from_jax, state_dict_from_jax, torch_checkpoint_from_jax

__all__ = ["fold_state_dict_from_jax", "state_dict_from_jax", "torch_checkpoint_from_jax"]
