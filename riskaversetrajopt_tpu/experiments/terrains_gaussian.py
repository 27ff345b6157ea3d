"""Friction-field visualization — parity with hopper/terrains_gaussian.py:
plot sampled random-Fourier-feature friction coefficient fields mu(px, omega)
over position."""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime
from riskaversetrajopt_tpu.core.config import HopperScenario
from riskaversetrajopt_tpu.experiments import common
from riskaversetrajopt_tpu.models.hopper import HopperModel


def main(argv=None):
    runtime.configure()
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-fields", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    model = HopperModel(HopperScenario())
    field = model.sample_friction(
        jax.random.PRNGKey(args.seed), args.num_fields, "saa"
    )
    pxs = jnp.linspace(-1.0, 3.0, 400)

    def mu_of(i, th, ta):
        return model.scn.mu_nom + jnp.sum(
            i[None, :] * jnp.cos(th[None, :] * pxs[:, None] + ta[None, :]),
            axis=1,
        )

    mus = jax.vmap(mu_of)(field.intensities, field.thetas, field.taus)

    plt = common.setup_matplotlib()
    fdir = common.figures_dir()
    fig = plt.figure(figsize=[6, 3])
    for i in range(args.num_fields):
        plt.plot(np.asarray(pxs), np.asarray(mus[i]), alpha=0.7)
    plt.axhline(model.scn.mu_nom, color="k", ls="--", lw=1)
    plt.xlabel("$p_x$")
    plt.ylabel(r"$\mu(p_x, \omega)$")
    fig.savefig(fdir / "hopper_friction_fields.png", dpi=150,
                bbox_inches="tight")
    print("saved", fdir / "hopper_friction_fields.png")


if __name__ == "__main__":
    main()
