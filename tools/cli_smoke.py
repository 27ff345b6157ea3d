"""Smoke-run every experiment CLI on the default JAX device in f32.

Each CLI runs IN-PROCESS at small problem sizes with --dtype f32 where the
flag exists (the rest run f32 naturally: x64 is off in this process).
Writes results under CLI_SMOKE_DIR (default: cli_smoke/ in the checkout,
which .gitignore lists) and prints one PASS/FAIL line per CLI plus a
SUMMARY line.

Usage: python tools/cli_smoke.py
"""

import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

from riskaversetrajopt_tpu import runtime  # noqa: E402

RUNS = [
    ("drone_risk", [
        "--alphas", "0.1", "0.2", "--repeats", "2", "--M", "50",
        "--mc-M", "2000", "--scp-iters", "15", "--dtype", "f32",
        "--plot", "--results", "results",
    ]),
    ("drone_gaussian", [
        "--alphas", "0.1", "--max-iter", "600", "--dtype", "f32",
        "--results", "results",
    ]),
    ("drone_times", [
        "--Ms", "20", "30", "--repeats", "2", "--scp-iters", "10",
        "--dtype", "f32", "--results", "results",
    ]),
    ("drone_main_plot", [
        "--alpha", "0.1", "--M", "50", "--mc-M", "2000",
        "--scp-iters", "15", "--dtype", "f32", "--plot",
        "--results", "results",
    ]),
    ("driving", [
        "--alphas", "0.05", "0.1", "--repeats", "2", "--M", "50",
        "--mc-M", "2000", "--scp-iters", "15", "--batched",
        "--dtype", "f32", "--plot", "--results", "results",
    ]),
    ("driving_gaussian", [
        "--alphas", "0.05", "0.1", "--scp-iters", "30", "--dtype", "f32",
        "--plot", "--results", "results",
    ]),
    ("hopper", [
        "--alphas", "0.3", "--mc-M", "2000", "--plot",
        "--results", "results",
    ]),
    ("terrains_gaussian", []),
]


def main():
    runtime.configure()
    workdir = os.environ.get("CLI_SMOKE_DIR", os.path.join(REPO, "cli_smoke"))
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    print(f"[cli_smoke] device={jax.devices()[0]} card={runtime.card_info()} "
          f"dir={workdir}", flush=True)
    results = {}
    for name, argv in RUNS:
        t0 = time.time()
        try:
            mod = __import__(
                f"riskaversetrajopt_tpu.experiments.{name}", fromlist=["main"]
            )
            mod.main(argv)
            results[name] = f"PASS {time.time()-t0:.0f}s"
        except Exception as e:  # noqa: BLE001 — smoke must report every CLI
            traceback.print_exc()
            results[name] = f"FAIL {type(e).__name__}: {str(e)[:150]}"
        print(f"[cli_smoke] {name}: {results[name]}", flush=True)

    ok = sum(1 for v in results.values() if v.startswith("PASS"))
    print(f"[cli_smoke] SUMMARY {ok}/{len(RUNS)} passed", flush=True)
    return 0 if ok == len(RUNS) else 1


if __name__ == "__main__":
    sys.exit(main())
