"""Binary trajectory/energy/state I/O (ref: src/saving.h)."""

from nbody_torch.io.saving import Saver, load_system, save_system

__all__ = ["Saver", "load_system", "save_system"]
