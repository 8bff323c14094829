"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Module paths mirror ``repro``: ``repro_torch/models/attention.py`` is the
counterpart of ``repro/models/attention.py``.  The port imports nothing of
``repro`` or JAX; it keeps its own copies of what it needs.  Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU.
"""
