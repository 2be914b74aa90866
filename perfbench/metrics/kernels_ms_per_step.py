"""kernels_ms_per_step (ms): device milliseconds a step of the kernels that
the port's own sources define (nbody_torch/csrc, its Triton code)."""


def read(rec: dict):
    kernels = [d for d in rec.get("device", []) if d["port"]]
    if not kernels:
        return None
    return sum(d["end"] - d["start"] for d in kernels) / 1e3 / rec["steps"]
