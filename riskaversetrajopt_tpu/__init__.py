"""riskaversetrajopt_tpu — risk-averse trajectory optimization on accelerators.

A from-scratch JAX/XLA framework implementing sample-average-approximation
(SAA) risk-averse trajectory optimization (Lew, Bonalli, Pavone, "Risk-Averse
Trajectory Optimization via Sample Average Approximation", arXiv:2307.03167),
with the capabilities of the reference StanfordASL/RiskAverseTrajOpt repository:

- stochastic dynamics models (car+pedestrian, drone, hopper) with Euler-Maruyama
  uncertainty propagation, vmapped/sharded over samples,
- CVaR (average-value-at-risk) constraints via the Rockafellar-Uryasev epigraph
  reformulation,
- sequential convex programming (SCP) with a custom on-chip ADMM QP solver
  (OSQP-equivalent semantics) — the full SCP loop runs as a single jitted XLA
  computation with no host round-trips,
- a primal-dual interior-point NLP solver (IPOPT-equivalent) for the
  direct-transcription hopper workload and the Gaussian drone baseline,
- Gaussian-linearization baselines (covariance propagation + quantile back-off),
- Monte-Carlo out-of-sample validation with AVaR/VaR estimators,
- multi-device scaling via `jax.sharding.Mesh` (samples sharded over
  devices, SAA reductions via psum).

Unlike the reference (CPU-pinned float64 scripts + native OSQP/IPOPT), every
hot path here is a compiled XLA program for an accelerator: `lax.scan` rollouts
with fused forward-mode linearization, structured sample-parallel KKT solves
(Schur complement over the sample axis), and batched problem-level parallelism
for (alpha x repeat) sweeps.
"""

__version__ = "0.1.0"

from riskaversetrajopt_tpu.core import config  # noqa: F401
