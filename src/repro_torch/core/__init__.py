"""Core algorithms of the port: LP relaxation (batched simplex), AMR^2
rounding, one-cell admission and the greedy local fill."""
