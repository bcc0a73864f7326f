"""The port's smokes: each one a `main(argv)` that returns 0 or 1, run as
``python -m repro_torch.scripts.<name>`` (ports of the reference's
`scripts/smoke_*.py`).  Each takes ``--device``: the CUDA card unless
given ``cpu``; with no card and no ``--device cpu`` it raises."""
