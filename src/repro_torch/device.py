"""Device resolution for the port's entry points.

``resolve(None)`` means the card: it raises when CUDA is absent instead of
carrying on on the CPU.  The CPU is used only when the caller asks for it
(the tests do).  The fp32 numerics are pinned: cuDNN's default TF32
convolutions would move the fitness scores of the reference fp32 round on
the card and flip threshold decisions, so both TF32 switches are turned
off here, at the entry point, on either device (on the CPU they change no
result, and the static analysis audits the same switches there).
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def plain_route(x) -> bool:
    """Whether a kernel wrapper runs its plain version on ``x``: True for
    a CPU tensor, False for a CUDA one (the kernel launches).  A fake
    tensor (the dry-run's, ``launch/dryrun.py``) holds no data for either
    and raises, as does any other device: nothing is counted as a launch
    or a plain run there."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(x):
        raise RuntimeError("a kernel wrapper was reached by a fake tensor: "
                           "no kernel or plain version runs on one")
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {x.device}")
