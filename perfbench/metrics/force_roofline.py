"""force_roofline (%): the least time one chip needs for the force work a
step of these bodies requires (roofline.py, the plain walk's count), over
the device time a step of the port's own kernels."""


def read(rec: dict):
    kernels = [d for d in rec.get("device", []) if d["port"]]
    if not kernels or not rec.get("bound_s"):
        return None
    busy_s = sum(d["end"] - d["start"] for d in kernels) / 1e6 / rec["steps"]
    return 100.0 * rec["bound_s"] / busy_s
