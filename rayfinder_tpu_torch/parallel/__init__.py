from .sharding import (
    RenderMesh, make_render_mesh, render_image_sharded, render_image_sharded_regen,
    render_step_sharded, render_step_sharded_regen,
)

__all__ = [
    "RenderMesh", "make_render_mesh", "render_step_sharded", "render_step_sharded_regen",
    "render_image_sharded", "render_image_sharded_regen",
]
