"""idle_share (fraction): the share of the traced stretch's wall time in
which no operation ran on the device, 1 - (union of the device operations'
intervals) / wall. A union, so overlapping kernels are not counted twice."""


def read(rec: dict):
    if not rec.get("device") or rec["wall_s"] <= 0:
        return None
    return 1.0 - rec["busy_s"] / rec["wall_s"]
