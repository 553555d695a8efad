"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``repro``'s layout (``configs/``, ``models/``,
``kernels/``, ``serving/``, ``launch/``) so each module's counterpart is
easy to find, and imports nothing from ``repro`` or ``jax``.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``; on the
CPU every hand-written kernel is replaced by its plain PyTorch version
(``kernels/ref.py``).
"""
