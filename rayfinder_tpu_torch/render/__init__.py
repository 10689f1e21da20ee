"""Rendering: device scene, camera, sampling, traversal (the stack walks and
the wavefront engine), the regen loops, the scan integrator, the progressive
Renderer and the deferred renderer."""
