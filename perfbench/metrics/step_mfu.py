"""step_mfu (%): the same least time of a step's force work over the whole
step's time on the device trace, the span from the traced stretch's first
device operation to its last over its steps, idle gaps included: the share
of the chip's peak that the step as a whole reaches, whatever kernel or
library does the work."""


def read(rec: dict):
    if not rec.get("bound_s") or not rec.get("span_s"):
        return None
    return 100.0 * rec["bound_s"] * rec["steps"] / rec["span_s"]
