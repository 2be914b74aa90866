"""glue_ms_per_step (ms): device milliseconds a step of the kernels that are
not the port's own: PyTorch's, launched by the plain-torch tree glue (keys,
sorts, scans, masks, gathers, the leapfrog)."""


def read(rec: dict):
    kernels = [d for d in rec.get("device", []) if d["cat"] == "kernel" and not d["port"]]
    if not kernels:
        return None
    return sum(d["end"] - d["start"] for d in kernels) / 1e3 / rec["steps"]
