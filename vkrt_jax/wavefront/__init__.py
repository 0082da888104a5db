from vkrt_jax.wavefront.engine import Renderer

__all__ = ["Renderer"]
