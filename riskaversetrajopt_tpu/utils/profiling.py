"""Profiling utilities.

The reference's profiling model is wall-clock define/solve pairs
(car/driving.py:482-498) — preserved as first-class metrics in
SAATrajOpt.solve_instrumented. This module adds the device layer:
jax.profiler traces viewable in TensorBoard/Perfetto (SURVEY.md section 5).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/rato_trace"):
    """Capture a jax.profiler trace of the enclosed block.

    Usage:
        with trace("/tmp/tr"):
            res = opt.solve(omegas, alpha)
            jax.block_until_ready(res.us)
    View with TensorBoard (`tensorboard --logdir /tmp/tr`) or upload the
    .pb.gz to ui.perfetto.dev.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    return jax.profiler.TraceAnnotation(name)
