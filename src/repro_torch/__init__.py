"""PyVertical in PyTorch for NVIDIA Hopper (H100) — the port of ``repro``.

The JAX package ``repro`` is the reference; this package re-implements
beside it the paper's split training path (DH-PSI entity resolution, the
dual-headed MLP SplitNN, joint and split training over the measured
transport, the int8 cut codec on a hand-written CUDA kernel,
``repro_torch/csrc/quantize.cu``) and split-LM serving (llama3.2-3b
behind the wave engine, every attention layer on a hand-written CUDA
flash-attention kernel, ``repro_torch/csrc/block_attention.cu``).

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).  The layout
mirrors the reference: ``repro_torch.core.splitnn`` is the counterpart
of ``repro.core.splitnn``, and so on.

Importing this package imports nothing heavy; subpackages load on use.
"""
