"""chip_smoke.py and the runtime helper on the CPU: the GPU guard, the result
line, the compile-cache and precision set-up, and the phases at tiny sizes
(the full-size phases run on the card: `python chip_smoke.py`)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from riskaversetrajopt_tpu import runtime
from riskaversetrajopt_tpu.core.config import DroneScenario
from riskaversetrajopt_tpu.models.drone import DroneModel
from riskaversetrajopt_tpu.scp.driver import SAATrajOpt


@pytest.fixture
def restore_runtime_config():
    saved = (jax.config.jax_default_matmul_precision,
             jax.config.jax_compilation_cache_dir)
    yield
    jax.config.update("jax_default_matmul_precision", saved[0])
    jax.config.update("jax_compilation_cache_dir", saved[1])


def test_guard_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])


def test_result_line_format():
    line = chip_smoke.result_line()
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}
    assert line.startswith('{"ok": true, "device": {"platform": "cpu", "kind": ')


@pytest.mark.parametrize("env_dir", [None, "custom-cache"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch, restore_runtime_config):
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(runtime.DEFAULT_CACHE_DIR)
        # fixed, inside the checkout, and ignored by git
        assert runtime.DEFAULT_CACHE_DIR.parent == chip_smoke.FIXTURES.parent.parent
        gitignore = (runtime.DEFAULT_CACHE_DIR.parent / ".gitignore").read_text()
        assert ".jax_cache/" in gitignore.split()
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert runtime.compile_cache_dir() == want
    runtime.configure()
    assert jax.config.jax_compilation_cache_dir == want


def test_configure_pins_highest_precision(restore_runtime_config):
    jax.config.update("jax_default_matmul_precision", None)
    runtime.configure()
    assert jax.config.jax_default_matmul_precision == "highest"


def test_device_record_names_the_device():
    rec = runtime.device_record()
    assert rec["platform"] == "cpu"
    assert rec["device_count"] == len(jax.devices())
    assert isinstance(rec["card"], str) and rec["card"]


def _library_solve(M, num_iters):
    """The same instance through the Python-driven SCP loop (separately
    jitted define and solve): an independent route to the phase's answer."""
    model = DroneModel(DroneScenario(M=M))
    om = model.sample(jax.random.PRNGKey(0), M=M)
    opt = SAATrajOpt(model, method="saa",
                     scp_cfg=chip_smoke.drone_scp_cfg(num_iters))
    return np.asarray(opt.solve_instrumented(om, chip_smoke.ALPHA)["us"])


@pytest.fixture(scope="module")
def gold8():
    return _library_solve(M=8, num_iters=15)


def test_phase_drone_f64_tiny(gold8):
    f = chip_smoke.phase_drone_f64(M=8, num_iters=15, mc_M=400, gold=gold8)
    assert f["dtype"] == "float64"
    assert f["l2_vs_golden"] <= 1e-6
    assert len(f["qp_iters"]) == 15 and f["admm_us_per_iter"] > 0


def test_phase_drone_f64_fails_loudly(gold8):
    with pytest.raises(chip_smoke.SmokeFailure, match="l2_vs_golden"):
        chip_smoke.phase_drone_f64(M=8, num_iters=15, mc_M=400,
                                   gold=2.0 * gold8)


def test_phase_drone_f32_toggles_x64(gold8):
    """The f32 phase runs in true f32 inside this x64 process and restores
    x64 afterwards."""
    assert jax.config.jax_enable_x64
    f = chip_smoke.phase_drone_f32(M=8, num_iters=15, mc_M=400, gold=gold8)
    assert f["dtype"] == "float32" and f["G_dtype"] == "float32"
    assert jax.config.jax_enable_x64
    assert jnp.zeros(1).dtype == jnp.float64


def test_phase_four_cards_matches_unsharded():
    """The --four-cards path on 4 of the virtual CPU devices: the sharded
    solve matches the one-device solve of the same instance."""
    gold = _library_solve(M=8, num_iters=2)
    f = chip_smoke.phase_four_cards(M=8, num_iters=2, n_devices=4, gold=gold)
    assert f["l2_vs_one_card"] <= 1e-8
    assert f["l2_vs_golden"] <= 1e-6


@pytest.mark.parametrize(
    "backend", ["_admm-pallas", "_admm-pallas-f", "admm-pallas", "admm-pallas-f"]
)
def test_removed_backend_raises(backend):
    """The fused-kernel backends are gone: their names raise, with no
    fallback to another backend."""
    model = DroneModel(DroneScenario(M=4))
    opt = SAATrajOpt(model, method="saa", qp_backend=backend,
                     scp_cfg=chip_smoke.drone_scp_cfg(1))
    om = opt.sample(jax.random.PRNGKey(0), M=4)
    with pytest.raises(ValueError, match="unknown qp backend"):
        opt.solve(om, alpha=0.2)


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_card):
    """`python chip_smoke.py` in a child process on the card: exit 0 and
    the result line as its last line of output."""
    import os
    import subprocess
    import sys

    root = chip_smoke.FIXTURES.parent.parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
