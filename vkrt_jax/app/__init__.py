from vkrt_jax.app.camera import Camera

__all__ = ["Camera"]
