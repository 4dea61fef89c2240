"""dfs_tpu_torch — the PyTorch/CUDA port of dfs_tpu's chunk-and-hash path.

The package mirrors ``dfs_tpu``'s layout (``ops/``, ``fragmenter/``,
``parallel/``, ``store/``, ``meta/``, ``utils/``, ``config.py``) and
imports neither JAX nor anything of
``dfs_tpu``: every piece it needs is a copy of its own. Device work runs
on an NVIDIA card through hand-written CUDA kernels (``csrc/``, built and
bound by :mod:`dfs_tpu_torch.kernels`); each kernel has a plain PyTorch
twin beside it that runs when the tensors lie on the CPU.

Entry points take an explicit ``device``. ``None`` means the card: with
no CUDA available they raise instead of carrying on on the CPU. Pass
``device="cpu"`` to run the plain versions on purpose (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else. Raises when CUDA is wanted (explicitly or by
    default) but not available — there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dfs_tpu_torch needs a CUDA device (torch.cuda.is_available()"
                " is False); pass device='cpu' to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
