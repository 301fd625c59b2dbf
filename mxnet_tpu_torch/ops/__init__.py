"""Operators of the port that run as hand-written CUDA kernels on the card,
each beside its plain PyTorch version (``attention``, ``linear``)."""
