from vkrt_jax.accel.lbvh import BVH2, build_lbvh, morton30

__all__ = ["BVH2", "build_lbvh", "morton30"]
