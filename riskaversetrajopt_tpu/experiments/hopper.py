"""Hopper contact-implicit workload — parity with hopper/hopper.py.

Two-phase workflow (hopper/README.md:9-25): solve the baseline NLP first,
persist it, then solve the SAA variants warm-started from the baseline —
here both phases run in one invocation (no flag-flipping needed), or
individually via --phase.

Monte-Carlo validation samples 10000 fresh friction fields and checks the
no-slip constraint on the solved contact schedule (hopper.py:898-1008).
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from riskaversetrajopt_tpu import runtime
from riskaversetrajopt_tpu.core.config import HopperScenario
from riskaversetrajopt_tpu.experiments import common
from riskaversetrajopt_tpu.models.hopper import HopperModel
from riskaversetrajopt_tpu.ops.cvar import avar
from riskaversetrajopt_tpu.ops.nlp_ipm import NLPConfig, solve_nlp


def solve_phase(model, field, method, alpha, Z0, tol, max_iter,
                damp_iters=0, damp_max=0.1, kkt_ruiz=None):
    if kkt_ruiz is None:
        kkt_ruiz = 0 if jnp.zeros(0).dtype == jnp.float64 else 3
    f, g, gL, gU, n_eq, xL, xU = model.make_nlp(field, method, alpha)
    res = solve_nlp(f, g, gL, gU, n_eq, xL, xU, Z0,
                    NLPConfig(tol=tol, max_iter=max_iter,
                              damp_iters=damp_iters, damp_max=damp_max,
                              kkt_ruiz_iters=kkt_ruiz))
    xs, us, ys, slack, t_risk = model.split_z(res.Z)
    return res, xs, us


def no_slip_violation(model, xs, us, field):
    """Per-sample max no-slip violation of a solved contact schedule on
    friction fields `field` (hopper.py:898-1008); safe where <= 1e-6."""
    ee = jax.vmap(model.end_effector_position)(jnp.asarray(xs))
    px = ee[model.contact_x_idx, 0]
    forces = jnp.asarray(us)[model.contact_u_idx, 2:]

    def one(i, th, ta):
        mu = model.scn.mu_nom + jnp.sum(
            i[None, :] * jnp.cos(th[None, :] * px[:, None] + ta[None, :]),
            axis=1,
        )
        return jnp.max(forces[:, 0] - mu * forces[:, 1])

    return jax.vmap(one)(field.intensities, field.thetas, field.taus)


def main(argv=None):
    runtime.configure()
    ap = argparse.ArgumentParser()
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.05, 0.1, 0.2, 0.3, 0.5, 0.75])
    ap.add_argument("--phase", choices=["baseline", "saa", "both"],
                    default="both")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--max-iter", type=int, default=3000)
    # first-steps fraction-to-boundary damping for the COLD baseline phase
    # (ops/nlp_ipm.NLPConfig.damp_iters). Measured (round 4, cold start from
    # the teleporting guess): undamped x64 needs ~2770 iters to reach the
    # jump-1.053 optimum (and f32 falls into a jump~0.03 basin at any
    # budget); with damp_iters=50/damp_max=0.1 BOTH precisions certify the
    # same jump-1.053 basin in ~60 iters. The warm-started SAA phase does
    # not use damping (it would only slow the ~40-70-iteration warm solves).
    ap.add_argument("--damp-iters", type=int, default=50)
    ap.add_argument("--damp-max", type=float, default=0.1)
    # symmetric KKT equilibration passes (f32 hardening; default: 0 under
    # x64, 3 when the process runs f32 — i.e. on accelerators)
    ap.add_argument("--kkt-ruiz", type=int, default=None)
    ap.add_argument("--mc-M", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--skip-mc", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--results", default="results")
    args = ap.parse_args(argv)

    rdir = common.results_dir(args.results)
    model = HopperModel(HopperScenario())
    M = model.M
    key = jax.random.PRNGKey(args.seed)
    field = model.sample_friction(key, M, "saa")
    field_base = model.sample_friction(key, M, "baseline")

    if args.phase in ("baseline", "both"):
        print("[hopper] >>> Solving baseline")
        Z0 = model.initial_guess(M)
        # The damped barrier path passes THROUGH a tol=1e-3-certifiable
        # iterate mid-solve (measured: certifies at iter 52 with jump 0.543,
        # vs the true optimum's 1.053 reached by iter ~69), so when damping
        # is on the baseline certifies at the tighter 1e-4 — still 40x fewer
        # iterations than the undamped reference workflow (IPOPT tol=1e-3 /
        # max_iter=3000, hopper/hopper.py:642-643, needs ~2770).
        base_tol = min(args.tol, 1e-4) if args.damp_iters > 0 else args.tol
        if base_tol != args.tol:
            print(f"[hopper] note: baseline tol tightened {args.tol:g} -> "
                  f"{base_tol:g} (damped path certifies prematurely at "
                  f"looser tol; pass --damp-iters 0 to keep --tol)")
        res, xs, us = solve_phase(
            model, field_base, "baseline", 0.1, Z0, base_tol, args.max_iter,
            damp_iters=args.damp_iters, damp_max=args.damp_max,
            kkt_ruiz=args.kkt_ruiz,
        )
        print(f"  iters={int(res.iters)} prim={float(res.prim_res):.2e} "
              f"jumped={float(xs[-1, 0]):.4f}")
        with open(rdir / "hopper_base_results.npy", "wb") as f:
            np.save(f, np.asarray(xs))
            np.save(f, np.asarray(us))

    if args.phase in ("saa", "both"):
        with open(rdir / "hopper_base_results.npy", "rb") as f:
            xs_g = np.load(f)
            us_g = np.load(f)
        s = model.scn
        Z0 = np.zeros(model.num_vars)
        Z0[: (s.S + 1) * s.n_x] = xs_g.reshape(-1)
        Z0[(s.S + 1) * s.n_x : (s.S + 1) * s.n_x + s.S * s.n_u] = us_g.reshape(-1)
        Z0 = jnp.asarray(Z0)
        for alpha in args.alphas:
            print(f"[hopper] >>> Solving SAA alpha={alpha}")
            res, xs, us = solve_phase(
                model, field, "saa", alpha, Z0, args.tol, args.max_iter,
                kkt_ruiz=args.kkt_ruiz,
            )
            print(f"  iters={int(res.iters)} prim={float(res.prim_res):.2e} "
                  f"jumped={float(xs[-1, 0]):.4f}")
            with open(rdir / f"hopper_saa_alpha={alpha}_results.npy", "wb") as f:
                np.save(f, np.asarray(xs))
                np.save(f, np.asarray(us))

    if not args.skip_mc:
        print("[hopper] >>> Monte Carlo validation")
        mc_field = model.sample_friction(
            jax.random.PRNGKey(args.seed + 100), args.mc_M, "saa"
        )
        names = [("baseline", rdir / "hopper_base_results.npy", None)] + [
            (f"alpha={a}", rdir / f"hopper_saa_alpha={a}_results.npy", a)
            for a in args.alphas
        ]
        for name, path, alpha in names:
            try:
                with open(path, "rb") as f:
                    xs = np.load(f)
                    us = np.load(f)
            except FileNotFoundError:
                continue
            mx = no_slip_violation(model, xs, us, mc_field)
            ok = mx <= 1e-6
            msg = (f"  {name}: jumped={xs[-1, 0]:.4f} "
                   f"safe={float(jnp.mean(ok)):.4f}")
            if alpha is not None:
                msg += f" avar={float(avar(mx, alpha)):.5f}"
            print(msg)

    if args.plot:
        # trajectory-snapshot figure (hopper/hopper.py:790-893): center of
        # mass (dashed) + end effector (solid) for the baseline in black and
        # each alpha on a bwr colormap, leg-link segments at selected
        # timesteps, ground fill, alpha colorbar
        print("[hopper] >>> Plotting trajectories")
        plt = common.setup_matplotlib()
        import matplotlib.pylab as pl_cm

        fdir = common.figures_dir()
        entries = []
        for a in args.alphas:
            try:
                with open(rdir / f"hopper_saa_alpha={a}_results.npy",
                          "rb") as f:
                    entries.append((a, np.load(f)))
            except FileNotFoundError:
                print(f"  results for alpha={a} missing "
                      "(run the saa phase first)")
        try:
            with open(rdir / "hopper_base_results.npy", "rb") as f:
                xs_base = np.load(f)
        except FileNotFoundError:
            xs_base = None
        if entries or xs_base is not None:
            ee_of = jax.vmap(model.end_effector_position)
            colors = pl_cm.cm.bwr(np.linspace(0, 1, max(len(entries), 1)))
            fig = plt.figure(figsize=[6, 3])
            xmin, xmax, ymin, ymax = -0.1, 1.25, -0.1, 1.75
            plt.plot([xmin, xmax], [0.0, 0.0], "r--")
            plt.fill_between([xmin, xmax], [-1, -1], [0.0, 0.0],
                             color="r", alpha=0.2)
            ts_to_plot = [0, 6, 10, 12, 14, 16, 18, 20, 24,
                          model.scn.S]

            def draw(xs, color, with_links, lw=3, a_line=1.0):
                com = xs[:, :2]
                ee = np.asarray(ee_of(jnp.asarray(xs)))
                plt.plot(com[:, 0], com[:, 1], c=color, ls="--",
                         lw=lw, alpha=a_line)
                plt.plot(ee[:, 0], ee[:, 1], c=color, ls="-",
                         lw=lw, alpha=a_line)
                if with_links:
                    plt.scatter(com[ts_to_plot, 0], com[ts_to_plot, 1],
                                c=[color], s=250, alpha=0.5)
                    for t in ts_to_plot:
                        plt.plot([com[t, 0], ee[t, 0]],
                                 [com[t, 1], ee[t, 1]],
                                 c=color, ls="-", lw=3, alpha=0.5)
                    plt.scatter(ee[ts_to_plot, 0], ee[ts_to_plot, 1],
                                c="#9d7200", s=50)

            if xs_base is not None:
                draw(xs_base, "k", with_links=True, lw=2, a_line=0.7)
            for i, (a, xs_a) in enumerate(entries):
                draw(xs_a, colors[i], with_links=(i == len(entries) - 1))
            if entries:
                sm = plt.cm.ScalarMappable(
                    cmap=pl_cm.cm.bwr,
                    norm=plt.Normalize(
                        vmin=min(a for a, _ in entries),
                        vmax=max(a for a, _ in entries),
                    ),
                )
                cbar = plt.colorbar(sm, ax=plt.gca(),
                                    ticks=[a for a, _ in entries])
                cbar.set_label(r"$\alpha$", rotation="horizontal")
            plt.xlabel("$p_x$")
            plt.ylabel("$p_z$", rotation=0)
            plt.xlim((xmin, xmax))
            plt.ylim((ymin, ymax))
            fig.savefig(fdir / "hopper_trajectories.png", dpi=150,
                        bbox_inches="tight")
            print("  saved", fdir / "hopper_trajectories.png")


if __name__ == "__main__":
    main()
