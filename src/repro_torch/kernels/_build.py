"""Build and bind the port's CUDA sources (``repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, ``build/lib<stem>-<hash>.so`` in the
checkout (content-addressed by the source, the ``csrc/*.cuh`` headers
and the flags), and is bound with ``ctypes``.  Nothing is built or loaded
at import: the first call of a kernel builds its library, and
:func:`build_all` builds every source at once, one ``nvcc`` process each,
all started together.  The builds persist across processes; what each
process pays again is the bind and the loads of the kernel modules on
their first launches.  :func:`build_counts` counts the ``nvcc`` processes
started and the libraries bound in this process.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600
_COUNTS = {"builds": 0, "binds": 0}


def build_counts() -> dict[str, int]:
    """``{"builds": nvcc processes started, "binds": libraries bound}`` in
    this process so far (each kernel module binds its library once)."""
    return dict(_COUNTS)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(f"nvcc not found: the port's CUDA kernels are built from "
                       f"{CSRC} with the CUDA toolkit")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the build of ``source`` lives: keyed by its bytes, the bytes of
    every ``*.cuh`` header beside it (so a changed header rebuilds every
    source there) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def all_built(sources: list[pathlib.Path] | None = None) -> bool:
    """True iff ``BUILD_DIR`` holds the current build of every source of
    ``sources`` (default: every ``csrc/*.cu``)."""
    sources = sorted(CSRC.glob("*.cu")) if sources is None else list(sources)
    return all(library_path(s).exists() for s in sources)


def build_all(sources: list[pathlib.Path] | None = None) -> dict[str, pathlib.Path]:
    """Build every missing library of ``sources`` (default: every
    ``csrc/*.cu``), one ``nvcc`` each, started together; returns
    ``{stem: library path}``.  Each write is atomic (temp file + rename),
    so concurrent first users never load a half-written file."""
    sources = sorted(CSRC.glob("*.cu")) if sources is None else list(sources)
    out = {s.stem: library_path(s) for s in sources}
    jobs = []
    try:
        for src in sources:
            if out[src.stem].exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            _COUNTS["builds"] += 1
            jobs.append((src, tmp, proc))
        for src, tmp, proc in jobs:
            try:
                _, err = proc.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise RuntimeError(f"nvcc timed out on {src}") from None
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{err}")
            os.replace(tmp, out[src.stem])
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def bind(source: pathlib.Path, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build ``source`` unless that exact build exists, load it, and
    declare each entry point's argument types (``c_void_p`` for pointers
    and streams, ``c_int`` for ints) and its ``int`` return, the launch's
    ``cudaError_t``."""
    lib = ctypes.CDLL(str(build_all([source])[source.stem]))
    _COUNTS["binds"] += 1
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def on_device(device):
    """The context a launch on ``device`` runs in: ``torch.cuda.device`` of
    a CUDA device, since the CUDA runtime launches (and sets a kernel's
    shared-memory attribute) on the *current* device, whatever stream it is
    given; nothing for ``None`` or the CPU."""
    if device is None or device.type != "cuda":
        return contextlib.nullcontext()
    import torch

    return torch.cuda.device(device)


def launch(lib, name: str, *args, device) -> None:
    """Call one entry point with ``device`` (the device of the tensors it
    launches on, or ``None`` for a query that takes none) current; raise if
    it reports a CUDA error."""
    with on_device(device):
        rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def on_cpu(what: str, *ts) -> bool:
    """True for an all-CPU call (plain path); False for an all-CUDA call on
    one device (kernel path); anything else raises — no silent device
    fallback."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"{what} need all tensors on one CUDA device or all on "
                     f"the CPU, got {sorted(str(t.device) for t in ts)}")


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as the ``void*`` the
    launchers take."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
