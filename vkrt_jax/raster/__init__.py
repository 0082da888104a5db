from vkrt_jax.raster.pipeline import render_raster_frame, Rasterizer

__all__ = ["render_raster_frame", "Rasterizer"]
