from vkrt_jax.shade.sampling import sample_material
from vkrt_jax.shade import shading

__all__ = ["sample_material", "shading"]
