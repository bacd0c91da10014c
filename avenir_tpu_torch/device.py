"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU, and never a silent CPU run."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for (or implied)
    and no CUDA device is available — the caller must pass ``"cpu"``
    explicitly to run on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "avenir_tpu_torch runs on CUDA by default, and no CUDA device is "
            "available; pass device='cpu' (CLI: --device cpu) to run on the "
            "CPU")
    return dev


def to_device(x, device: torch.device) -> torch.Tensor:
    """A chunk array on ``device``: a numpy array is wrapped and copied, a
    tensor the feeder already staged there is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(x).to(device)
