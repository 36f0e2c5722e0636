"""PyTorch/CUDA port of the MLProxy system, beside the JAX package.

Mirrors the JAX package's layout module for module. It imports ``torch``
and ``numpy`` and nothing of JAX or of the JAX package: the control-plane
modules it needs are its own copies. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
