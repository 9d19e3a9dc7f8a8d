"""Geometry, correlation, segment and BA ops of the port.  Importing them
builds and loads no CUDA library: the kernels build at first use."""
from . import lie, projective, scatter, corr, graph

__all__ = ["lie", "projective", "scatter", "corr", "graph"]
