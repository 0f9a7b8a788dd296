"""Seeded violations, one per rule of the port's gate: each module defines
`RULE` and `build(device)` and must make `python -m hefl_tpu_torch.analysis
--fixture <module>.py` exit 1 under its rule."""
