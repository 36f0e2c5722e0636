"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their plain
PyTorch versions (``ref.py``) and the model-layout wrappers (``ops.py``).
Nothing is built at import; ``build.py`` runs nvcc at first use."""
