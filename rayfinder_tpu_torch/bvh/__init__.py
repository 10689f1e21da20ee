"""BVH build (binned SAH, numpy and native) and the triangle-to-cluster rule.

The port's own copy of `rayfinder_tpu.bvh` (numpy and a C++ builder).
"""

from .build import Bvh, build_bvh, reorder_attributes

__all__ = ["Bvh", "build_bvh", "reorder_attributes"]
