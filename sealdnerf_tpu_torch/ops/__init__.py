"""Ops of the port: ray/AABB, encodings, hat lerp, compositing, the dense
march, and the fused field kernel (ops/field.py)."""
