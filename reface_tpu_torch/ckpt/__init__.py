from reface_tpu_torch.ckpt.from_jax import (
    arcface_from_jax,
    bisenet_from_jax,
    clip_conditioner_from_jax,
    conditioner_from_jax,
    landmark_head_from_jax,
    landmark_net_from_jax,
    lpips_from_jax,
    swap_from_jax,
    unet_from_jax,
    vae_from_jax,
)

__all__ = ["arcface_from_jax", "bisenet_from_jax", "clip_conditioner_from_jax",
           "conditioner_from_jax", "landmark_head_from_jax", "landmark_net_from_jax",
           "lpips_from_jax", "swap_from_jax", "unet_from_jax", "vae_from_jax"]
