"""PyTorch / CUDA port of the RSQ system for one NVIDIA H100.

Mirrors the layout of the JAX reference package (``configs``, ``core``,
``models``, ``kernels/<name>``, ``checkpoint``, ``data``, ``launch``) so a
reader finds each counterpart.  Importing the package imports nothing
heavy; kernels are compiled with ``nvcc`` at first use (``kernels/build``).
"""
