"""Marching-tets shape stack: the thickness and morphing tasks (counterpart of `diffsound_tpu/geometry/`)."""
