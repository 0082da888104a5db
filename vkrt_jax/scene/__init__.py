from vkrt_jax.scene.model import Model, Submesh, Material, Image
from vkrt_jax.scene.gltf import load_model
from vkrt_jax.scene.flatten import FlatScene, flatten_model
from vkrt_jax.scene.generate import generate_model
from vkrt_jax.scene.textures import TextureHeap, build_texture_heap


def load_scene(spec: str, max_texture_dim: int = 0) -> Model:
    """A scene by spec: "generated" or "generated:<seed>" builds the
    seeded reference scene (scene/generate.py, seed 0 by default); any
    other spec is a glTF path."""
    name, _, seed = spec.partition(":")
    if name == "generated":
        return generate_model(int(seed or 0), max_texture_dim)
    return load_model(spec, max_texture_dim=max_texture_dim)


__all__ = [
    "Model", "Submesh", "Material", "Image", "load_model", "load_scene",
    "generate_model", "FlatScene", "flatten_model",
    "TextureHeap", "build_texture_heap",
]
