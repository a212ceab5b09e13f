"""The entry points' CPU-checkable pieces: the GPU requirement, the
compile-cache helper, and chip_smoke.py's parts at tiny sizes (its phases
on the card are run by ``python chip_smoke.py``)."""
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from modulatedgps_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path,
                                             cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert runtime.REPO_CACHE_DIR == want
    assert runtime.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        runtime.require_gpu()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_without_gpu(script):
    """No GPU: non-zero exit and no result line, never a CPU fallback."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"metric"' not in res.stdout
    assert "GPU" in res.stderr


def test_chip_smoke_final_line_format():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.final_line([dev])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_chip_smoke_reference_matches_package_float64():
    """The plain reference computes the package's SMGP loss: in float64,
    at the package's float64 jitter, the two agree to rounding."""
    M, N = 10, 24
    model = chip_smoke.perturb(chip_smoke.build_model(M, jnp.float64))
    Xn, Yn = chip_smoke.make_data(N)
    X, Y = jnp.asarray(Xn), jnp.asarray(Yn)
    z, g = model.draw_noise(jax.random.PRNGKey(0), N, chip_smoke.S,
                            jnp.float64)
    ref, ref_aux = chip_smoke.reference_loss(model, X, Y, z, g, jitter=1e-6)
    got, got_aux = chip_smoke.product_loss(model, X, Y, z, g)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-10)
    np.testing.assert_allclose(float(got), float(model.training_loss(
        jax.random.PRNGKey(0), X, Y)), rtol=1e-10)
    for k in ref_aux:
        np.testing.assert_allclose(np.asarray(got_aux[k]),
                                   np.asarray(ref_aux[k]), rtol=1e-8,
                                   atol=1e-10)


def test_chip_smoke_compare_at_tiny_size():
    """Phase 5's comparison at a tiny size: every row within tolerance,
    every gradient leaf and every head cotangent compared."""
    rows = chip_smoke.compare_to_reference(12, 40)
    names = {r.name for r in rows}
    assert {"loss", "fmean", "fvar", "amean", "avar", "kl_pred",
            "kl_assign"} <= names
    assert {f"dloss/d{k}" for k in chip_smoke.MARGINALS} <= names
    assert len([n for n in names if n.startswith("grad")]) == 11
    assert all(r.ok for r in rows), [r for r in rows if not r.ok]


@pytest.mark.parametrize("side", ["reference", "product"])
def test_chip_smoke_split_gradient_is_the_gradient(side):
    """Phase 5's gradient, split at the layer terms, is the loss gradient
    when the exact terms and cotangent are the side's own (float64)."""
    fns = {"reference": (chip_smoke.reference_terms,
                         chip_smoke.reference_head,
                         chip_smoke.reference_loss),
           "product": (chip_smoke.product_terms, chip_smoke.product_head,
                       chip_smoke.product_loss)}
    terms_fn, head_fn, loss_fn = fns[side]
    M, N = 10, 24
    model = chip_smoke.perturb(chip_smoke.build_model(M, jnp.float64))
    Xn, Yn = chip_smoke.make_data(N)
    X, Y = jnp.asarray(Xn), jnp.asarray(Yn)
    z, g = model.draw_noise(jax.random.PRNGKey(0), N, chip_smoke.S,
                            jnp.float64)
    exact = terms_fn(model, X)
    ct = jax.grad(head_fn, argnums=1)(model, exact, Y, z, g)
    out = chip_smoke._side(terms_fn, head_fn, model, X, Y, z, g, exact, ct)
    grads = jax.grad(lambda m: loss_fn(m, X, Y, z, g)[0])(model)
    leaves = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(leaves) == 11
    for path, leaf in leaves:
        np.testing.assert_allclose(
            np.asarray(out["grad" + jax.tree_util.keystr(path)]),
            np.asarray(leaf), rtol=1e-9, atol=1e-12)
    for k in chip_smoke.MARGINALS:
        np.testing.assert_allclose(np.asarray(out[f"dloss/d{k}"]),
                                   np.asarray(ct[k]), rtol=1e-12,
                                   atol=1e-14)


def test_chip_smoke_precision_probe_on_cpu():
    errs = chip_smoke.precision_probe(64)
    assert set(errs) == {"DEFAULT", "HIGH", "HIGHEST"}
    assert all(e < 1e-5 for e in errs.values()), errs


def test_chip_smoke_four_gpu_phase_on_cpu_mesh():
    """The --four-gpu phase's meshes and comparison on four virtual CPU
    devices at a small size."""
    chip_smoke.phase_four_gpu(M=32, N=64, steps=2,
                              devices=jax.devices()[:4])
