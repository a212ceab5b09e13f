"""Score inducing-input gradients against a float64 ground truth.

Judging gradient precision by agreement with a HIGHEST-precision run AT
MODEL INIT is void: with the whitened init (q_mu = 0, q_sqrt = I) the
marginals are exactly (0, Knn) — independent of Z — so the TRUE
Z-gradient is zero and every float32 mode's Z-gradient is pure
cancellation noise.  The protocol here: perturb the variational state to a
trained-like point (identical f64 values cast per arm), compute the
Z-gradients once in float64 (the truth) and once per precision mode on the
device, and report relative error and correlation vs the truth.

Inputs are .npz captures: ``--truth`` holds gZp/gZa (pred/assign layer,
f64); ``--device`` holds <mode>_p / <mode>_a per precision mode; the
optional ``--cpu32`` holds an exact-f32 CPU capture with identical draws,
which separates device matmul arithmetic from the dtype of the MC draws.
Emits one JSON line + optional --out.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--truth", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--cpu32", default=None,
                   help="optional exact-f32 CPU capture with draws "
                        "identical to the device arms")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    t = np.load(args.truth)
    g = np.load(args.device)
    c32 = np.load(args.cpu32) if args.cpu32 else None
    modes = sorted({k.rsplit("_", 1)[0] for k in g.files})
    res = {}
    for layer, suf in (("pred", "p"), ("assign", "a")):
        truth = t[f"gZ{suf}"].astype(np.float64)
        scale = np.abs(truth).max()
        row = {"truth_absmax": float(scale)}
        for mode in modes:
            a = g[f"{mode}_{suf}"].astype(np.float64)
            row[mode] = {
                "rel_err_vs_f64": float(np.abs(a - truth).max() / scale),
                "corr_vs_f64": float(np.corrcoef(
                    a.ravel(), truth.ravel())[0, 1]),
            }
        if c32 is not None:
            cpu = c32[f"gZ{suf}"].astype(np.float64)
            row["cpu_exact_f32"] = {
                "rel_err_vs_f64": float(np.abs(cpu - truth).max() / scale),
                "corr_vs_f64": float(np.corrcoef(
                    cpu.ravel(), truth.ravel())[0, 1]),
            }
            sc = np.abs(cpu).max()
            for mode in modes:
                a = g[f"{mode}_{suf}"].astype(np.float64)
                row[mode]["rel_err_vs_cpu_f32"] = float(
                    np.abs(a - cpu).max() / sc)
                row[mode]["corr_vs_cpu_f32"] = float(np.corrcoef(
                    a.ravel(), cpu.ravel())[0, 1])
        res[layer] = row
        print(f"{layer}: " + ", ".join(
            f"{m}: err={row[m]['rel_err_vs_f64']:.3e} "
            f"corr={row[m]['corr_vs_f64']:.4f}" for m in modes),
            file=sys.stderr)

    out = {"metric": "z_grad_precision_vs_f64_truth",
           "protocol": "perturbed variational state (identical f64 "
                       "values cast per arm); f64 truth vs device modes",
           "layers": res}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
