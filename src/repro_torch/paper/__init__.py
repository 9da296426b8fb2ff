"""Torch twins of the paper's experiment drivers (`benchmarks/` of the
JAX package): `common` (the scaled grid and ``run_setting``),
`table1_accuracy` (Table I), `fig2_accuracy` (Fig. 2) and `convergence`
(Theorem 1 on a quadratic)."""
