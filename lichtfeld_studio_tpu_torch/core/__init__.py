"""Containers: point cloud, camera, splat model."""
