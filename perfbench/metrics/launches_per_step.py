"""launches_per_step (launches): the CUDA kernels of the traced stretch,
the port's and PyTorch's, over its steps."""


def read(rec: dict):
    kernels = sum(d["cat"] == "kernel" for d in rec.get("device", []))
    return kernels / rec["steps"] if kernels else None
