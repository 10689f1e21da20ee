"""Host-side scene loading: textures, glTF, flattening, procedural scenes.

The port's own copy of `rayfinder_tpu.scene` (numpy only); it imports
nothing of the JAX package.
"""

from .texture import Texture
from .gltf import GltfMesh, GltfScene, load_gltf
from .flatten import FlattenedScene

__all__ = ["Texture", "GltfMesh", "GltfScene", "load_gltf", "FlattenedScene"]
