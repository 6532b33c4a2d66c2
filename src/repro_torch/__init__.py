"""PyVertical in PyTorch for NVIDIA Hopper (H100) — the port of ``repro``.

The JAX package ``repro`` is the reference; this package re-implements
beside it the paper's split training path (DH-PSI entity resolution, the
dual-headed MLP SplitNN, joint and split training over the measured
transport, the int8 cut codec on a hand-written CUDA kernel,
``repro_torch/csrc/quantize.cu``) and split-LM serving behind the wave
engine: llama3.2-3b, every attention layer on a hand-written CUDA
flash-attention kernel (``repro_torch/csrc/block_attention.cu``), and
zamba2-2.7b, every Mamba2 prefill on a hand-written CUDA SSD scan
kernel (``repro_torch/csrc/mamba2_scan.cu``).

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``).  The layout
mirrors the reference: ``repro_torch.core.splitnn`` is the counterpart
of ``repro.core.splitnn``, and so on.

Importing this package imports nothing heavy; subpackages load on use.
"""
