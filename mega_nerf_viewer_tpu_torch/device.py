"""Device selection shared by every entry point of the port.

Entry points take ``device=None``, which means the CUDA card.  Without a
card that raises: the port never drops to the CPU unless the caller asks
for it with ``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else ``device`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def host_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Host data ``x`` as a ``dtype`` tensor on ``device``.  To a CUDA
    device it goes through pinned memory with a non-blocking copy, so
    building a frame's small inputs (camera, bbox) never waits on the card;
    elsewhere this is ``torch.as_tensor``."""
    device = torch.device(device)
    t = torch.as_tensor(x, dtype=dtype)
    if t.device == device or device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
