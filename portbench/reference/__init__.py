"""The plain reference: the renderer's arithmetic in torch, over a BVH of its
own built from the triangles the benchmark made. It imports nothing of the
program (tests/test_portbench_imports.py holds it to that)."""
