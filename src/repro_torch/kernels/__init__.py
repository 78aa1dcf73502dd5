"""Hand-written Hopper kernels of the port.

Each kernel directory holds three parts:

* ``<name>.py`` — the ctypes wrapper over the CUDA C++ source in
  ``csrc/<name>.cu`` (built by :mod:`repro_torch.kernels._build`), with
  a launch counter ``LAUNCHES``, a plain integer on the module;
* ``ref.py`` — the plain PyTorch version of the same function, with the
  contract of the reference's ``ref.py``;
* ``ops.py`` — ``impl="auto"|"kernel"|"ref"``: ``"auto"`` is the kernel
  for a CUDA tensor and the plain version for a CPU tensor.  A CUDA
  tensor gets the kernel or an exception, never a silent fallback.
"""


def resolve_impl(impl: str, t) -> str:
    """"auto" -> "kernel" for a CUDA tensor, "ref" for a CPU tensor."""
    if impl == "auto":
        return "kernel" if t.is_cuda else "ref"
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown kernel impl: {impl!r}")
    return impl
