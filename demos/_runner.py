"""Generic SMGP/SMGPModified demo runner.

Each demo family (reference demos/demo_tf2*.py, demo_john_doe*.py) is the
same pipeline with different data, kernels, likelihood and model variant;
this runner owns the pipeline, the demo files own the configuration —
the typed-config analog of the reference's inline constants (SURVEY.md §5.6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from _common import bootstrap, demo_argparser, save_figure, predict_in_batches


@dataclasses.dataclass
class DemoConfig:
    name: str
    load_data: Callable         # rng -> (N, Xtrain, Ytrain, Xtest[, attrs])
    K: int
    iters: int
    pred_kernel: tuple          # (variance, lengthscales)
    assign_kernel: tuple
    multiclass: bool = False    # MultiClass pred lik + SMGPModified
    modified: bool = False      # SMGPModified with Gaussian assign lik
    lik_variance: float = 0.5
    plot_1d: bool = True        # 4-panel 1-D figure (else 2-D 2-figure set)
    axis_labels: tuple = ("x1", "x2")   # 2-D axis names (John Doe: stumps)


def run(cfg: DemoConfig, argv=None):
    args = demo_argparser(dict(iters=cfg.iters, K=cfg.K)).parse_args(argv)
    jax = bootstrap(args.platform, debug_nans=args.debug_nans)

    import jax.numpy as jnp
    import modulatedgps_tpu as mgp
    from modulatedgps_tpu.ops.kernels import SquaredExponential
    from modulatedgps_tpu.likelihoods import Gaussian, MultiClass
    from modulatedgps_tpu.data import minibatch_iterator
    from modulatedgps_tpu.utils import kmeans_centers
    from modulatedgps_tpu.training import (run_adam, save_checkpoint,
                                           restore_checkpoint)

    rng = np.random.default_rng(args.seed)
    loaded = cfg.load_data(rng)
    N, Xtrain, Ytrain, Xtest = loaded[:4]
    K = args.K

    pred_kernel = SquaredExponential.create(*cfg.pred_kernel)
    assign_kernel = SquaredExponential.create(*cfg.assign_kernel)
    Z = kmeans_centers(Xtrain, args.num_inducing, seed=0)
    Z_assign = kmeans_centers(Xtrain, args.num_inducing, seed=1)

    assign_lik = Gaussian.create(variance=cfg.lik_variance, D=K)
    if cfg.multiclass:
        lik = MultiClass.create(K)
    else:
        lik = Gaussian.create(variance=cfg.lik_variance, D=K)

    pred_layer = mgp.SVGP.create(pred_kernel, Z, num_latent_gps=K, whiten=True)
    assign_layer = mgp.SVGP.create(assign_kernel, Z_assign, num_latent_gps=K,
                                   whiten=True)
    if cfg.multiclass or cfg.modified:
        model = mgp.SMGPModified(likelihood=lik, assign_likelihood=assign_lik,
                                 pred_layer=pred_layer, assign_layer=assign_layer,
                                 K=K, num_samples=args.num_samples, num_data=N)
    else:
        model = mgp.SMGP(likelihood=lik, pred_layer=pred_layer,
                         assign_layer=assign_layer, K=K,
                         num_samples=args.num_samples, num_data=N)
    if args.resume:
        model = restore_checkpoint(args.resume, model)
    mgp.print_summary(model)

    metrics = None
    if args.metrics:
        from modulatedgps_tpu.utils import MetricsLogger
        metrics = MetricsLogger(args.metrics, verbose=False)
    it = minibatch_iterator(Xtrain, Ytrain, args.batch, seed=args.seed)
    # --checkpoint + --checkpoint-every N = preemption-safe training: the
    # full TrainState is saved atomically every N steps and a rerun of the
    # same command resumes from the last save.
    model, iters, elbos = run_adam(
        model, args.iters, it, args.lr, key=jax.random.PRNGKey(args.seed),
        callback=(lambda i, e, s: metrics.log(i, elbo=e)) if metrics else None,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume=bool(args.checkpoint and args.checkpoint_every))
    if metrics:
        metrics.close()
    mgp.print_summary(model)
    if args.checkpoint and not args.checkpoint_every:
        # model-only artifact (pairs with --resume); with --checkpoint-every
        # the file already holds the full TrainState from the periodic saves.
        save_checkpoint(args.checkpoint, model)

    # ---- predictions -----------------------------------------------------
    # Serving path: both layers' X-independent linear algebra is folded into
    # cached tensors once (models/posterior.py::precompute_smgp) — each
    # prediction batch is one kernel build + matmuls, no Cholesky/solves.
    # jit with the model as an ARGUMENT (never closed over, which would
    # bake its arrays into the compiled program as constants).
    from modulatedgps_tpu.models.posterior import precompute_smgp
    serving = precompute_smgp(model)
    key = jax.random.PRNGKey(args.seed + 1)
    S = args.predict_samples
    j_samples = jax.jit(lambda m, k, xb: m.predict_samples(k, xb, S=S))
    j_assign = jax.jit(lambda m, xb: m.predict_assign(xb))
    j_predy = jax.jit(lambda m, xb: m.predict_y(xb))
    # Mixture samples for ALL configs: the reference multiclass demos plot
    # the Gaussian-reparam-over-class-probs sample scatter too
    # (reference demos/demo_tf2_modified_multiclass.py:68-93,
    # demo_john_doe_multi_class.py:73-81).
    samples_y, samples_f = predict_in_batches(
        lambda xb: j_samples(serving, key, jnp.asarray(xb)), Xtest)
    assign_probs = np.asarray(j_assign(serving, jnp.asarray(Xtrain)))
    fmean, fvar = j_predy(serving, jnp.asarray(Xtest))
    fmean_, fvar_ = np.asarray(fmean).mean(0), np.asarray(fvar).mean(0)

    if elbos:
        print(f"final ELBO {elbos[-1]:.4f}")
    else:
        # Resumed run already at/past --iters: no new steps, no history —
        # report the restored model's training loss instead of crashing.
        loss = jax.jit(lambda m, k, xb, yb: m.training_loss(k, xb, yb))(
            model, jax.random.PRNGKey(args.seed),
            jnp.asarray(Xtrain[:args.batch]), jnp.asarray(Ytrain[:args.batch]))
        print(f"no new steps (resumed past --iters); restored ELBO "
              f"{-float(loss):.4f}")

    if not args.no_plot:
        import matplotlib
        matplotlib.use("Agg")
        from modulatedgps_tpu.utils.plotting import (four_panel_figure,
                                                     two_figure_2d)
        if cfg.plot_1d:
            # Same 4-panel layout for Gaussian AND multiclass configs
            # (reference demo_tf2_modified_multiclass.py:81-118 draws the
            # identical panels, sample scatter included).
            fig = four_panel_figure(Xtrain, Ytrain, Xtest, samples_y,
                                    samples_f, iters, elbos, Xtrain,
                                    assign_probs, Xtest, fmean_, fvar_, K)
            save_figure(fig, args.out, f"{cfg.name}.png")
        else:
            # 2-D inputs: the reference's dedicated two-figure layout
            # (demos/demo_tf2_2d.py:77-178; John Doe figure parity,
            # demo_john_doe.py:82-184 — VERDICT r1 missing #2).
            assign_plot = np.asarray(j_assign(serving, jnp.asarray(Xtest)))
            c0, c1 = -0.25, 0.75   # stumpsX/x1 and stumpsY/x2 constants
            line = np.linspace(Xtrain.min(0), Xtrain.max(0), 200)
            slice_X = [np.c_[line[:, 0], np.full(200, c1)],
                       np.c_[np.full(200, c0), line[:, 1]]]
            slices = []
            for i, Xs in enumerate(slice_X):
                a = np.asarray(j_assign(serving, jnp.asarray(Xs)))
                fm, fv = j_predy(serving, jnp.asarray(Xs))
                fm, fv = np.asarray(fm).mean(0), np.asarray(fv).mean(0)
                slices.append((Xs, i, c1 if i == 0 else c0, a, fm, fv))
            fig_3d, fig2 = two_figure_2d(
                Xtrain, Ytrain, Xtest, samples_y, samples_f, iters, elbos,
                assign_plot, fmean_, slices, K, axis_labels=cfg.axis_labels)
            save_figure(fig_3d, args.out, f"{cfg.name}_1.png")
            save_figure(fig2, args.out, f"{cfg.name}_2.png")

    return model, iters, elbos
