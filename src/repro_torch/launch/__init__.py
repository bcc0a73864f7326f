"""Launchers of the port.  `serve` (the period-T serving loop on the
paper_edge LM ladder, `python -m repro_torch.launch.serve`), `steps`
(the train, eval, prefill and decode step factories), `train` (the
fault-tolerant training driver on one device, `python -m
repro_torch.launch.train`), and the multi-device tooling of ROADMAP §1
item 13: `mesh` (named `DeviceMesh`es), `specs` (the dry run's shape
grid), `roofline` (H100 roofline terms), `op_cost` (per-rank op counts,
the counterpart of the reference's `hlo_cost`) and `dryrun` (`python -m
repro_torch.launch.dryrun`)."""
