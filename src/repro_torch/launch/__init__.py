"""Launchers of the port.  Ported: `serve` (the period-T serving loop on
the paper_edge LM ladder, `python -m repro_torch.launch.serve`).  Not
ported yet: the reference's `train`, `steps`, `dryrun` and the mesh and
roofline tooling (ROADMAP §1 items 12 and 13)."""
