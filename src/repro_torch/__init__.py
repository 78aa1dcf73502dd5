"""PyTorch/CUDA port of the MPG reproduction, one slice at a time.

``src/repro/`` (JAX/Pallas) is the reference; this package is its
counterpart for an NVIDIA H100.  It imports ``torch`` and never ``jax``
or anything under ``repro``: where it needs a framework-free module of
the reference it keeps its own copy.

The slice ported so far is the serving path on dense decoders: the
continuous engine over the batched paged-decode executor, with a
hand-written flash-attention kernel for prefill and a hand-written
paged-attention kernel for decode (``repro_torch.kernels``).  Entry
points run on CUDA unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``).
"""
