"""PyTorch/CUDA port of the GreenPod TOPSIS scheduling system.

Mirrors the JAX package ``repro`` module for module (``repro_torch.core.
scheduler`` is the port of ``repro.core.scheduler``) and imports nothing
from it. Scoring backends are ``numpy`` (the float64 reference semantics),
``torch`` (eager torch ops on a given device) and ``cuda`` (the hand-written
Hopper kernels in ``repro_torch.kernels``).
"""
