"""Plain SVGP 3-class classification sanity demo.

Analog of the reference's dependency check
reference demos/from_online/demo_multiclass_lik.py: C=3 latent functions
sampled from a SquaredExponential GP prior, labels = argmax; model is an
SVGP with a Matern32 + White(0.01) sum kernel, RobustMax MultiClass
likelihood, q_diag=True, inducing points Z = X[::5] frozen along with the
White variance (set_trainable parity), trained full-batch with the Scipy
L-BFGS optimizer.
"""
import numpy as np

from _common import bootstrap, demo_argparser, save_figure


def main():
    args = demo_argparser(dict(iters=1000, K=3)).parse_args()
    bootstrap(args.platform, debug_nans=args.debug_nans)

    import jax.numpy as jnp
    from modulatedgps_tpu.models import SVGP
    from modulatedgps_tpu.ops.kernels import Matern32, SquaredExponential, Sum, White
    from modulatedgps_tpu.likelihoods import MultiClass, RobustMax
    from modulatedgps_tpu.params import Module, print_summary, set_trainable, static_field
    from modulatedgps_tpu.training import run_scipy

    C, N = args.K, 100
    rng = np.random.default_rng(args.seed)
    X = rng.random((N, 1))

    # Latent prior sample under an SE kernel, labels = argmax over C.
    se = SquaredExponential.create(1.0, 0.1)
    Kxx = np.asarray(se.K(jnp.asarray(X))) + np.eye(N) * 1e-6
    f = rng.multivariate_normal(np.zeros(N), Kxx, size=C).T          # [N, C]
    Y = np.argmax(f, axis=1).astype(np.float64)[:, None]

    kernel = Sum(kernels=(
        Matern32.create(1.0, 1.0),
        White.create(0.01),
    ))
    # Freeze the White variance (reference demo_multiclass_lik.py:128).
    white = kernel.kernels[1]
    kernel = kernel.replace(kernels=(
        kernel.kernels[0],
        white.replace(variance=set_trainable(white.variance, False))))

    Z = X[::5].copy()
    svgp = SVGP.create(kernel, Z, num_latent_gps=C, whiten=True, q_diag=True)
    # Freeze the inducing inputs (reference demo_multiclass_lik.py:129).
    svgp = svgp.replace(Z=set_trainable(svgp.Z, False))
    lik = MultiClass.create(C, invlink=RobustMax(num_classes=C))

    class SVGPClassifier(Module):
        svgp: SVGP
        likelihood: MultiClass
        num_data: int = static_field(default=N)

        def elbo(self, X, Y):
            fmu, fvar = self.svgp.predict_f(X)
            ve = self.likelihood.variational_expectations(fmu, fvar, Y)
            return jnp.sum(ve) - self.svgp.prior_kl()

    model = SVGPClassifier(svgp=svgp, likelihood=lik, num_data=N)
    Xj, Yj = jnp.asarray(X, svgp.Z.dtype), jnp.asarray(Y, svgp.Z.dtype)
    print_summary(model)
    # Data threaded through the jitted objective as arguments (never closed
    # over, which would bake it into the program as constants).
    model, result = run_scipy(model, lambda m, X_, Y_: -m.elbo(X_, Y_),
                              data=(Xj, Yj), maxiter=args.iters, verbose=True)
    print_summary(model)

    fmu, _ = model.svgp.predict_f(Xj)
    acc = float(np.mean(np.argmax(np.asarray(fmu), axis=1) == Y.ravel()))
    print(f"final ELBO: {float(model.elbo(Xj, Yj)):.4f}  train acc: {acc:.3f} "
          f"(L-BFGS nit={result.nit})")

    if not args.no_plot:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
        xx = np.linspace(X.min(), X.max(), 200)[:, None]
        mu, var = model.svgp.predict_f(jnp.asarray(xx, svgp.Z.dtype))
        p, _ = model.likelihood.predict_mean_and_var(mu, var)
        mu, var, p = np.asarray(mu), np.asarray(var), np.asarray(p)
        colors = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728"]
        fig, (a1, a2) = plt.subplots(2, 1, sharex=True, figsize=(10, 7))
        for c in range(C):
            col = colors[c % len(colors)]
            a1.plot(xx, mu[:, c], color=col, lw=2, label=str(c))
            a1.plot(xx, mu[:, c] + 2 * np.sqrt(var[:, c]), "--", color=col)
            a1.plot(xx, mu[:, c] - 2 * np.sqrt(var[:, c]), "--", color=col)
            a2.plot(xx, p[:, c], "-", color=col, lw=2)
            a2.plot(X[Y.ravel() == c], np.zeros(np.sum(Y.ravel() == c)) - 0.05,
                    ".", color=col)
        a1.set_title("posterior latents")
        a1.legend()
        a2.set_title("predicted class probabilities")
        a2.set_ylim(-0.12, 1.1)
        save_figure(fig, args.out, "demo_multiclass_svgp.png")


if __name__ == "__main__":
    main()
