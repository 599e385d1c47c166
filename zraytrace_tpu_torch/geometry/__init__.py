"""Geometry: ray-primitive intersection."""
