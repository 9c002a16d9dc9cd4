"""PyTorch/CUDA port of the Three-Chains runtime (see ``repro`` for the JAX
reference it mirrors module for module)."""

__all__: list[str] = []
