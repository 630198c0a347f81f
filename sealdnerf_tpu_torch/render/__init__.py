"""Occupancy grid and renderers of the port."""
