"""Device rule of the port's entry points."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere;
    when it is asked for and absent this raises, and never falls back to
    the CPU (callers that want the CPU say ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the card unless "
                "the caller passes device='cpu'"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def compute_dtype(
    device: torch.device, dtype: Optional[torch.dtype]
) -> torch.dtype:
    """bf16 on the card (the reference's compute dtype), float32 on the
    CPU, unless the caller names one."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def seeded_init_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Deterministic random weights from an explicit ``torch.Generator``:
    LeCun-normal convolution and linear kernels with zero biases (flax's
    defaults), torch's uniform LSTM init, BatchNorm at identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=gen) / fan_in ** 0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.LSTM):
                bound = 1.0 / m.hidden_size ** 0.5
                for p in m.parameters():
                    u = torch.rand(p.shape, generator=gen) * 2 - 1
                    p.copy_(u * bound)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.reset_parameters()
    return module

