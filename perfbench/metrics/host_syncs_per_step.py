"""host_syncs_per_step (syncs): the operations of one step that make the
host wait for the device, counted under CUDA's sync debug mode."""


def read(rec: dict):
    return rec.get("host_syncs")
