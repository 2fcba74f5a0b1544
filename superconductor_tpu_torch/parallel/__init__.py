from .bands import RenderMesh, make_render_mesh, render_frame_sharded

__all__ = ["RenderMesh", "make_render_mesh", "render_frame_sharded"]
