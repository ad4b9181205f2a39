"""Hand-written CUDA kernels of the port (``repro.kernels`` counterpart).

:mod:`.bloom` holds the five Bloom-signature kernels, ``bloom.onehot``
the two seed one-hot Bloom kernels of the seed reference simulator,
:mod:`.lazy_merge` the LazySync row merge, :mod:`.flash_attention` the
attention of the model zoo's prefill.  The helpers here read and reset
the launch counter of every kernel wrapper at once;
:func:`._build.build_all` compiles every CUDA source at once.
"""

from __future__ import annotations

import importlib

# The kernel modules (not the package-level wrappers of the same names).
_KERNEL_MODULES = ("repro_torch.kernels.bloom.bloom",
                   "repro_torch.kernels.bloom.onehot",
                   "repro_torch.kernels.lazy_merge.lazy_merge",
                   "repro_torch.kernels.flash_attention.flash_attention")


def _kernel_modules():
    return [importlib.import_module(m) for m in _KERNEL_MODULES]


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for mod in _kernel_modules():
        mod.reset_launch_counts()


def launch_counts() -> dict[str, int]:
    """``{kernel name: launches}`` over every kernel of the port."""
    out: dict[str, int] = {}
    for mod in _kernel_modules():
        out.update(mod.launch_counts())
    return out

