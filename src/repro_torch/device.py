"""Device policy of the entry points: CUDA unless the caller asks for the
CPU, and never a quiet fall back to the CPU; and the one device sync the
package uses."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (or implied)
    and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run the plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on the calling thread's current stream of
    ``device`` (nothing on the CPU). Not a sync of the whole device: under
    the async engine the serving and the mutation thread run on streams of
    their own, and neither waits for the other's kernels."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
