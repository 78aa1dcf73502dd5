"""PyTorch/CUDA port of the MPG reproduction, one slice at a time.

``src/repro/`` (JAX/Pallas) is the reference; this package is its
counterpart for an NVIDIA H100.  It imports ``torch`` and never ``jax``
or anything under ``repro``: where it needs a framework-free module of
the reference it keeps its own copy.

Ported so far: the serving paths of the dense, MoE, hybrid and ssm
decoders (the continuous engine over the batched paged-decode and the
per-slot executors) and the training path of the dense and MoE
families (``launch.train``, ``runtime``, ``optim``, ``data``), with
hand-written CUDA kernels for every TPU kernel and for the attention and
grouped-matmul backwards (``repro_torch.kernels``).  Entry points run on CUDA unless the caller
passes ``device="cpu"`` (``repro_torch.device.resolve_device``).
"""
