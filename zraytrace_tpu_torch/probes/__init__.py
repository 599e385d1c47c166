"""Micro-benchmarks that ask what bounds the port's kernels on the card.

Counterparts of the TPU probes under ``tools/``: ``rng_probe`` (PCG4D's
integer multiplies), ``inkernel_texel_probe`` (a texel fetch inside a
kernel), ``body_probe`` (slices of the bounce body) and ``flash3_probe``
(the flash chunk body in four layouts). Each has a hand-written CUDA
kernel (``csrc/probe_*.cu``) and a plain PyTorch version, and runs as
``python -m zraytrace_tpu_torch.probes.<name> [--cpu] [variant ...]``.
"""
