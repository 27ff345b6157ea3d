"""Base interface for SAA stochastic trajectory-optimization models.

A model packages the pieces the reference keeps as per-script methods
(``Model.b``, ``Model.sigma``, ``us_to_state_trajectory``,
``*_constraints`` in car/driving.py:160-236 and drone/drone_risk.py:122-213)
into pure functions over an explicit per-sample uncertainty pytree ``omega``:

- ``drift(x, u, omega)``            -- the SDE drift b(x, u, omega)
- ``dispersion(x, u, omega, dW)``   -- sigma(x, u, omega) @ dW, in matvec form
  (the reference materializes a dense n_x*n_x sigma matrix
  per step; every sigma in these workloads is a scaled identity on a state
  block, so the matvec form avoids an n_x^2 intermediate entirely)
- ``x0(omega)``                     -- per-sample initial state
- ``ineq_constraints(xs, omega)``   -- the K per-sample inequality constraints
  g(x) <= 0 that enter the CVaR epigraph
- ``final_constraints(xs)``         -- equality rows driven to zero in
  sample-average (SAA with delta_M = 0, car/driving.py:309-313)
- ``sample(key, M, method)``        -- draw omega for M samples ('saa' or
  'baseline' zeroed-uncertainty variants)

All functions are jit/vmap/jacfwd-compatible; the uncertainty pytree carries
the Brownian increments ``dWs`` alongside parametric uncertainty so a single
vmap axis covers everything.
"""

from __future__ import annotations

import copy
from typing import Any, Protocol

import jax.numpy as jnp

Omega = Any  # per-sample uncertainty pytree


class ConstBind:
    """Pass array-valued model constants across jit boundaries as ARGUMENTS.

    A `lax.scan` body that touches an array rooted in a closure-baked
    jaxpr CONSTANT paid a large per-step cost on the runtime this was first
    built for; passed as jit arguments, the constants cost nothing per
    step. Whether baking costs anything on the H100 is not measured.
    Models declare their array constants in `const_attrs`;
    `consts()` gathers them into a pytree to pass across the jit boundary
    and `bind()` returns a shallow copy of the model with the traced
    values swapped in, so every downstream use is argument-rooted.
    """

    const_attrs: tuple = ()

    def consts(self):
        return {k: getattr(self, k) for k in self.const_attrs}

    def bind(self, consts):
        m = copy.copy(self)
        for k, v in consts.items():
            setattr(m, k, v)
        return m


class SAAModel(Protocol):
    n_x: int
    n_u: int
    S: int
    K: int  # number of per-sample inequality constraints
    n_fc: int  # number of final (equality) constraint rows
    dt: float
    row_scale: float  # conditioning multiplier on CVaR sample rows

    def drift(self, x: jnp.ndarray, u: jnp.ndarray, omega: Omega) -> jnp.ndarray: ...

    def dispersion(
        self, x: jnp.ndarray, u: jnp.ndarray, omega: Omega, dW: jnp.ndarray
    ) -> jnp.ndarray: ...

    def x0(self, omega: Omega) -> jnp.ndarray: ...

    def ineq_constraints(self, xs: jnp.ndarray, omega: Omega) -> jnp.ndarray: ...

    def final_constraints(self, xs: jnp.ndarray) -> jnp.ndarray: ...

    def sample(self, key, M: int, method: str = "saa") -> Omega: ...

    def initial_guess(self) -> jnp.ndarray: ...
