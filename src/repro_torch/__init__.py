"""Chargax in PyTorch for NVIDIA Hopper: the port of the JAX package ``repro``.

Imports torch, numpy and the standard library only; nothing of JAX or of the
JAX package.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
