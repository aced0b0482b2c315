"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  With no card and no explicit CPU
request they raise: a rebalance never quietly moves to the CPU.  Lags stay
int64 on every device (Kafka offsets are Java longs), the rule the JAX
package enforces with ``ops/dispatch.ensure_x64``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is present); anything else
    is taken as asked, and a CUDA device is checked for a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def fetch(*tensors):
    """Numpy copies of tensors on one device, with one synchronisation for
    all of them on the card (the calling thread's current stream)."""
    if tensors[0].device.type == "cpu":
        return tuple(t.numpy() for t in tensors)
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(t.numpy() for t in host)


def carry_cuda_context(device: torch.device) -> Callable[[], ContextManager]:
    """Capture, on the calling thread, the CUDA device a call on ``device``
    runs on (its index, or the thread's current device) and that device's
    current stream; return a zero-argument context-manager factory that,
    entered on ANOTHER thread, makes them that thread's current device and
    stream.  PyTorch keeps both per thread, and a new thread starts on
    device 0 and its default stream whatever the caller set: the
    watchdog's solve worker enters this so its launches go where the
    caller's would.  A CPU device carries nothing."""
    if device.type != "cuda":
        return contextlib.nullcontext
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index)

    @contextlib.contextmanager
    def enter():
        with torch.cuda.device(index), torch.cuda.stream(stream):
            yield

    return enter
