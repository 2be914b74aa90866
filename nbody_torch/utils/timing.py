"""Device synchronization for timing (the port of nbody_tpu.utils.timing).

The port's work is queued on the GPU and returns before the device has
finished; sync waits for it, the analog of the reference's device sync
when it reads timers (timer.h:6-11). On the CPU the work is done when the
call returns, and sync does nothing.
"""

from __future__ import annotations

import torch


def sync(device: torch.device) -> None:
    """Wait until `device` has finished all queued work; a no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
