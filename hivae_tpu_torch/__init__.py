"""PyTorch/CUDA port of hivae_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout (``ops``, ``models``, ``pipelines``,
``utils``); the TPU Pallas kernels on the ported path are hand-written CUDA
under ``csrc`` (see ``ops/kernels``). Imports torch and numpy only.
"""
