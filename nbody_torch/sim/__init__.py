"""Step-loop runners, warmup/timing protocol, CSV emission (ref: run_* loops)."""
