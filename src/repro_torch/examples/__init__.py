"""The port's examples, each a `main(argv)` run as ``python -m
repro_torch.examples.<name>`` (ports of the reference's `examples/`):
the planner's `fleet_sim`, `mobility_sim`, `hi_sim`, `capacity_plan`,
`amdp_identical`, and the training driver's `train_lm`.  Each takes the
reference's flags plus ``--device``: the CUDA card unless given ``cpu``;
with no card and no ``--device cpu`` it raises."""
