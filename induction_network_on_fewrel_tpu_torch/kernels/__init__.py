"""Build and load the package's hand-written CUDA kernels (``build.py``)."""
