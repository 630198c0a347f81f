"""Ops of the port: ray/AABB, encodings, hat lerp, compositing, the dense
march, the fused field kernel (ops/field.py), and the Morton codes and
occupancy bitfield of the reference's API (morton.py, packbits.py)."""
