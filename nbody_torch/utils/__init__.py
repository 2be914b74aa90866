"""Timing helpers of nbody_torch."""
