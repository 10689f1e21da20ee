"""Rendering: device scene, camera, sampling, traversal, the regen loops, the
scan integrator and the progressive Renderer."""
