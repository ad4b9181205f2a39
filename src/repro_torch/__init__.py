"""PyTorch/CUDA port of :mod:`repro` (the LazyPIM coherence simulator).

The module tree mirrors ``repro``: ``repro_torch.core.signatures`` is the
counterpart of ``repro.core.signatures`` and so on.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); the Bloom-signature hot path
runs through the hand-written CUDA kernels of
:mod:`repro_torch.kernels.bloom` on the card and through their plain
PyTorch versions on the CPU.
"""
