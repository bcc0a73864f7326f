"""Launchers of the port.  Ported: `serve` (the period-T serving loop on
the paper_edge LM ladder, `python -m repro_torch.launch.serve`), `steps`
(the train, eval, prefill and decode step factories) and `train` (the
fault-tolerant training driver on one device, `python -m
repro_torch.launch.train`).  Not ported yet: the reference's `dryrun` and
the mesh and roofline tooling (ROADMAP §1 item 13)."""
