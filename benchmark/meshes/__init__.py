"""Mesh generators, one module a kind, found by a configuration's
``mesh.kind``. Each defines ``make(**params) -> (verts float32 (N, 3),
tris uint32 (M, 3))``. Frozen copies: a later change to the program's own
generators does not move the benchmark."""
