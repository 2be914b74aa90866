"""Opt-in machinery that no default path runs (the port of
nbody_tpu.experimental): reached only through the octree fast path's
descend_levels (ablate tokens desc1 / desc2) and the knob probe
(python -m nbody_torch.probe knobs)."""
