"""Shared demo scaffolding: env bootstrap, argument parsing, figure output.

The reference demos are CLI-less scripts with inline constants
(reference demos/demo_tf2.py:25-34).  Here each demo keeps those defaults
but exposes them as flags (SURVEY.md §5.6 config system) plus:
  --platform {gpu,cpu}  gpu (default) exits when JAX finds no GPU; cpu runs
                        the float64 parity mode
  --iters N --no-plot --out DIR --seed S --metrics FILE
"""
from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def bootstrap(platform: str = "gpu", debug_nans: bool = False):
    """Configure JAX before first use. Returns the jax module."""
    import jax
    if platform == "cpu":
        # float64 on CPU for parity with the reference's gpflow defaults.
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    else:
        from modulatedgps_tpu.utils.runtime import (enable_compile_cache,
                                                    require_gpu)
        require_gpu()
        enable_compile_cache()
    if debug_nans:
        from modulatedgps_tpu.config import enable_debug_checks
        enable_debug_checks(nans=True)
    print(f"devices: {jax.devices()}")
    return jax


def demo_argparser(defaults: dict) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=defaults.get("iters", 2000))
    p.add_argument("--lr", type=float, default=defaults.get("lr", 0.005))
    p.add_argument("--batch", type=int, default=defaults.get("batch", 500))
    p.add_argument("--num-samples", type=int, default=defaults.get("num_samples", 25))
    p.add_argument("--predict-samples", type=int,
                   default=defaults.get("predict_samples", 100))
    p.add_argument("--num-inducing", type=int, default=defaults.get("num_inducing", 25))
    p.add_argument("--K", type=int, default=defaults.get("K", 3))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--out", default=os.path.join(_REPO, "figs"))
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--checkpoint", default=None, help="save final model here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also save the FULL train state every N steps to "
                        "--checkpoint (atomic; rerunning resumes from it)")
    p.add_argument("--resume", default=None, help="restore model before training")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise on the first NaN-producing op (slow; dev only)")
    return p


def save_figure(fig, out_dir: str, name: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=110)
    print(f"figure -> {path}")


def predict_in_batches(fn, X, batch: int = 500):
    """Host-side chunking of prediction inputs (parity with reference
    demos/demo_tf2.py:62-68)."""
    import numpy as np
    n_batches = max(int(X.shape[0] / batch), 1)
    outs = None
    for xb in np.array_split(X, n_batches):
        res = fn(xb)
        if not isinstance(res, tuple):
            res = (res,)
        if outs is None:
            outs = [[] for _ in res]
        for acc, r in zip(outs, res):
            acc.append(np.asarray(r))
    cat = [np.concatenate(a, axis=-2) for a in outs]
    return cat[0] if len(cat) == 1 else tuple(cat)
