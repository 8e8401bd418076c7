"""Device resolution and the kernel tier rule of the PyTorch port.

The JAX package picks its tier from the backend and the shapes
(``paddle_tpu/ops/pallas/__init__.py`` ``kernel_enabled``: a Pallas
kernel on a TPU with aligned shapes, the jnp refer path otherwise). The
port's rule is simpler and takes no shape into account: a tensor on a
CUDA device goes to the hand-written kernel, a tensor on the CPU to the
kernel's plain PyTorch version. There is no environment switch and no
fallback from the kernel to the plain version.

Entry points take ``device=None`` and run on ``cuda`` then; without a
CUDA device they raise instead of running on the CPU behind the
caller's back. The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_abstract = threading.local()


@contextlib.contextmanager
def abstract_evaluation():
    """Within this block (on this thread) ``meta`` tensors take the plain
    versions: the emitters run over shapes and dtypes only."""
    prev = getattr(_abstract, "on", False)
    _abstract.on = True
    try:
        yield
    finally:
        _abstract.on = prev


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when ``device`` is
    None, else ``device`` itself. Raises when CUDA is asked for (or
    defaulted to) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def uses_kernel(*tensors: torch.Tensor) -> bool:
    """The tier rule: True when every tensor lies on one CUDA device
    (launch the kernel), False when every tensor lies on the CPU (run
    the plain version). Anything else raises.

    Inside :func:`abstract_evaluation`, ``meta`` tensors (no data, only
    shape and dtype) take the plain version too: that is build-time shape
    inference (``core/shape_inference.py``), which computes nothing, and
    not a fallback. A CUDA tensor still launches its kernel or raises,
    and outside that context a meta tensor raises like any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(str(d) for d in devices)}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    if dev.type == "meta" and getattr(_abstract, "on", False):
        return False
    raise ValueError(f"unsupported device {dev} (cuda or cpu)")
