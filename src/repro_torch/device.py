"""Device selection shared by every entry point of the port.

``device=None`` means the CUDA card.  Without a card the entry points
raise instead of carrying on on the CPU: a CPU run happens only when the
caller asks for it with ``device="cpu"`` (as the CPU parity tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Normalize a ``device=`` argument; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when no GPU is visible, so a
    missing card is never silently replaced by the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "visible; pass device='cpu' to run the plain PyTorch path "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    return dev


def same_device(t: torch.Tensor, device: torch.device) -> bool:
    """True iff tensor ``t`` lives on ``device`` (index-insensitive on CPU)."""
    if t.device.type != device.type:
        return False
    return device.type == "cpu" or t.device.index == device.index
