"""The byte-compatible `.pt` scene format (PTFORMAT3).

The port's own copy of `rayfinder_tpu.io`.
"""

from .ptformat import PtScene, read_pt, write_pt

__all__ = ["PtScene", "read_pt", "write_pt"]
