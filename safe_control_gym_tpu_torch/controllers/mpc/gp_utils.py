"""Gaussian-process regression for GP-MPC, in PyTorch.

Port of ``safe_control_gym_tpu/controllers/mpc/gp_utils.py``: exact GPs with
a zero mean and an SE or Matern 5/2 ARD kernel, one GP an output dimension,
trained by Adam on the exact negative marginal log likelihood.

* The kernels broadcast over leading dimensions of their length scales and
  signal variances: with (D, d) length scales and (D,) variances they give
  the D output dimensions' covariances at once, where JAX vmaps.
* Training is a host loop of autograd steps of ``math/optim.py``'s Adam
  (optax's defaults: b1 0.9, b2 0.999, eps 1e-8), where JAX runs a
  ``lax.scan`` of ``optax.adam``; the loop reads nothing back from the device.
* The Cholesky factor is ``torch.linalg.cholesky_ex`` without error checks,
  NaN where the matrix is not positive definite (JAX's answer), so that
  neither a raise nor a sync sits in the loop.
* Prediction is plain tensor algebra (Cholesky solves), so the posterior mean
  enters the MPC's dynamics and ``torch.func.jacfwd`` differentiates it.
* ``kmeans_centriods`` draws its first centroids with
  ``np.random.default_rng(rand_state)``: the JAX package draws them with
  ``jax.random.choice``, whose stream the port cannot reproduce.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd

from safe_control_gym_tpu_torch.math.linalg import full_matmul_precision
from safe_control_gym_tpu_torch.math.optim import adam_init, adam_update

__all__ = ['cov_se_ard', 'cov_matern52_ard', 'GaussianProcess',
           'GaussianProcessCollection', 'BatchGaussianProcess',
           'lhs_sample', 'kmeans_centriods', 'lloyd_iterations']

# The keys of a GP's parameters, in JAX's leaf order (sorted).
PARAM_KEYS = ('log_lengthscales', 'log_noise_var', 'log_signal_var')


def _scaled_diff(x1, x2, lengthscales):
    """(..., n1, n2, d): the pairwise differences over the length scales."""
    return (x1[..., :, None, :] - x2[..., None, :, :]) / lengthscales[..., None, None, :]


def cov_se_ard(x1, x2, lengthscales, signal_var):
    """Squared-exponential ARD kernel, (..., n1, n2)."""
    d = _scaled_diff(x1, x2, lengthscales)
    return signal_var[..., None, None] * torch.exp(-0.5 * torch.sum(d ** 2, dim=-1))


def cov_matern52_ard(x1, x2, lengthscales, signal_var):
    """Matern 5/2 ARD kernel, (..., n1, n2). ``r = sqrt(sum d^2 + 1e-12)``
    keeps the gradient finite at r = 0 (``torch.cdist`` rounds otherwise and
    has no such guard)."""
    d = _scaled_diff(x1, x2, lengthscales)
    r = torch.sqrt(torch.sum(d ** 2, dim=-1) + 1e-12)
    sr5 = math.sqrt(5.0) * r
    return signal_var[..., None, None] * (1 + sr5 + 5.0 / 3.0 * r ** 2) * torch.exp(-sr5)


KERNELS = {'RBF': cov_se_ard, 'Matern': cov_matern52_ard}


def _cholesky(K):
    """Lower Cholesky factor of (..., n, n), NaN where K is not positive
    definite (as JAX's), with no error check and so no host read."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float('nan')))


def _eye(n, ref):
    return torch.eye(n, dtype=torch.float32, device=ref.device)


def _hyper(params):
    """(length scales, signal variance, noise variance) of log parameters."""
    return (torch.exp(params['log_lengthscales']), torch.exp(params['log_signal_var']),
            torch.exp(params['log_noise_var']))


def _nll(params, X, Y, kernel_fn):
    """Negative exact marginal log likelihood of targets Y (..., N) at the
    inputs X (N, d); leading dimensions of Y and of the parameters are
    independent GPs."""
    ls, sv, nv = _hyper(params)
    n = X.shape[-2]
    K = kernel_fn(X, X, ls, sv) + (nv + 1e-6)[..., None, None] * _eye(n, X)
    L = _cholesky(K)
    alpha = torch.cholesky_solve(Y[..., None], L)[..., 0]
    log_2pi = torch.log(torch.tensor(2 * math.pi, dtype=torch.float32, device=X.device))
    return (0.5 * torch.sum(Y * alpha, dim=-1)
            + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
            + 0.5 * n * log_2pi)


@full_matmul_precision
def _adam_fit(params, loss_fn, n_train, learning_rate, track_fn=None):
    """``n_train`` Adam steps on ``loss_fn(params)`` (summed over its leading
    dimensions, which are independent). Returns the final parameters and
    losses (the loss before the last step), or, with ``track_fn``, the
    parameters and value of the step whose ``track_fn`` was lowest, kept by
    ``torch.where`` per leading entry. No host read inside."""
    leaves = [params[k].detach().clone() for k in PARAM_KEYS]
    state = adam_init(leaves)
    best, best_l, loss = None, None, None
    for _ in range(n_train):
        ps = [p.requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(dict(zip(PARAM_KEYS, ps)))
            grads = torch.autograd.grad(loss.sum(), ps)
        updates, state = adam_update(list(grads), state, learning_rate)
        leaves = [(p + u).detach() for p, u in zip(ps, updates)]
        loss = loss.detach()
        if track_fn is not None:
            with torch.no_grad():
                track = track_fn(dict(zip(PARAM_KEYS, leaves)))
            if best is None:
                best_l = torch.full_like(track, float('inf'))
                best = leaves
            better = track < best_l
            best = [torch.where(better.reshape(better.shape + (1,) * (p.dim() - better.dim())),
                                p, b) for p, b in zip(leaves, best)]
            best_l = torch.where(better, track, best_l)
    if track_fn is not None:
        return dict(zip(PARAM_KEYS, best)), best_l
    return dict(zip(PARAM_KEYS, leaves)), loss


def _as_f32(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _init_params(shape, input_dim, device):
    """Unit length scales and signal variance, noise variance 0.1 (its log
    taken in float32, as JAX's)."""
    log_nv = torch.log(torch.tensor(0.1, device=device))
    return {'log_lengthscales': torch.zeros(shape + (input_dim,), device=device),
            'log_signal_var': torch.zeros(shape, device=device),
            'log_noise_var': log_nv.expand(shape).clone()}


class GaussianProcess:
    """One output dimension's exact GP (a zero mean, an ARD kernel)."""

    def __init__(self, input_dim, kernel='Matern', noise_prior=None, device='cpu'):
        self.input_dim = input_dim
        self.kernel_name = kernel
        self.kernel_fn = KERNELS[kernel]
        self.device = torch.device(device)
        self.params = _init_params((), input_dim, self.device)
        self.X = None
        self.Y = None
        self._alpha = None
        self._chol = None
        # Online learning's capacity: padded slots carry 1e6 point noise, so
        # they add nothing measurable to the posterior while data streams in;
        # the arrays keep their shapes, as in the JAX package.
        self._point_noise = None
        self._n0 = None     # the first online slot
        self._ptr = None    # the next online slot (a ring over [_n0, capacity))

    def train(self, X, Y, n_train=500, learning_rate=0.01, verbose=False):
        """Adam on the exact NLL; returns the loss before the last step."""
        X = _as_f32(X, self.device)
        Y = _as_f32(Y, self.device).reshape(-1)
        kernel_fn = self.kernel_fn
        self.params, loss = _adam_fit(self.params, lambda p: _nll(p, X, Y, kernel_fn),
                                      n_train, learning_rate)
        self.X, self.Y = X, Y
        self._precompute()
        return float(loss)

    @full_matmul_precision
    def _precompute(self):
        """The factor of K + (noise + 1e-6) I (+ the point noise) and alpha
        (the JAX package also caches the inverse, which nothing reads)."""
        ls, sv, nv = _hyper(self.params)
        n = self.X.shape[0]
        K = self.kernel_fn(self.X, self.X, ls, sv) + (nv + 1e-6) * _eye(n, self.X)
        if self._point_noise is not None:
            K = K + torch.diag(self._point_noise)
        L = _cholesky(K)
        self._chol = L
        self._alpha = torch.cholesky_solve(self.Y[:, None], L)[:, 0]

    @full_matmul_precision
    def predict(self, x_star, return_pred=False):
        """Posterior mean and variance at ``x_star`` (n, d), numpy."""
        x_star = torch.atleast_2d(_as_f32(x_star, self.device))
        ls, sv, _ = _hyper(self.params)
        k_star = self.kernel_fn(x_star, self.X, ls, sv)
        mean = k_star @ self._alpha
        v = torch.cholesky_solve(k_star.T, self._chol)
        var = sv - torch.sum(k_star * v.T, dim=1)
        return mean.cpu().numpy(), var.cpu().numpy()

    def make_casadi_prediction_func(self):
        """The posterior mean z (d,) -> scalar as a function of tensors
        (the role of the reference's CasADi export): ``torch.func``
        differentiates it."""
        X, alpha, kernel_fn = self.X, self._alpha, self.kernel_fn
        ls, sv, _ = _hyper(self.params)

        @full_matmul_precision
        def mean_fn(z):
            return (kernel_fn(torch.atleast_2d(z), X, ls, sv) @ alpha)[0]
        return mean_fn

    def prediction_jacobian(self, z):
        """d mean / d z, numpy."""
        fn = self.make_casadi_prediction_func()
        return jacfwd(fn)(_as_f32(z, self.device)).detach().cpu().numpy()

    @full_matmul_precision
    def fitc_weights(self, z_ind):
        """FITC weights ``w`` (M,) with mean(z*) = K(z*, Z) w:

            w = Sigma Kzx Lambda^-1 y,  Sigma = (Kzz + Kzx Lambda^-1 Kxz)^-1,
            Lambda = diag(Kxx - Qxx) + sigma^2 I.

        Both inverses are eigendecompositions whose eigenvalues under
        1e-5 sv are dropped (long length scales make Kzz nearly singular in
        float32)."""
        Z = _as_f32(z_ind, self.device)
        ls, sv, nv = _hyper(self.params)
        kernel_fn = self.kernel_fn

        def psd_solve(M, B, eps):
            evals, evecs = torch.linalg.eigh(M)
            inv = torch.where(evals > eps, 1.0 / torch.clamp(evals, min=eps),
                              torch.zeros_like(evals))
            return (evecs * inv) @ (evecs.T @ B)

        eps = 1e-5 * sv
        Kzz = kernel_fn(Z, Z, ls, sv)
        Kzx = kernel_fn(Z, self.X, ls, sv)
        V = psd_solve(Kzz, Kzx, eps)                    # Kzz^+ Kzx
        Qxx_diag = torch.sum(Kzx * V, dim=0)
        # The FITC diagonal, clipped: Qxx can exceed the prior variance by
        # rounding.
        lam = torch.clamp(sv - Qxx_diag, min=0.0) + nv + 1e-6
        if self._point_noise is not None:
            lam = lam + self._point_noise       # padded slots stay invisible
        A = Kzz + (Kzx / lam[None, :]) @ Kzx.T
        return psd_solve(A, (Kzx / lam[None, :]) @ self.Y, eps)

    def make_fitc_prediction_func(self, z_ind):
        """The FITC mean z (d,) -> scalar built from :meth:`fitc_weights`."""
        Z = _as_f32(z_ind, self.device)
        w = self.fitc_weights(z_ind)
        ls, sv, _ = _hyper(self.params)
        kernel_fn = self.kernel_fn

        @full_matmul_precision
        def mean_fn(z):
            return (kernel_fn(torch.atleast_2d(z), Z, ls, sv) @ w)[0]
        return mean_fn

    def pad_capacity(self, capacity: int):
        """Reserve ``capacity - N`` slots for online learning: zero inputs and
        targets with 1e6 point noise."""
        n = int(self.X.shape[0])
        if capacity <= n:
            return
        d = int(self.X.shape[1])
        dev = self.device
        self.X = torch.cat([self.X, torch.zeros((capacity - n, d), device=dev)])
        self.Y = torch.cat([self.Y, torch.zeros((capacity - n,), device=dev)])
        self._point_noise = torch.cat([torch.zeros((n,), device=dev),
                                       torch.full((capacity - n,), 1e6, device=dev)])
        self._n0 = n
        self._ptr = n
        self._precompute()

    def add_data(self, x_new, y_new):
        """Add observations and refresh the posterior's factor, the
        hyperparameters kept. With a padded capacity the rows fill the
        reserved slots as a ring; otherwise the arrays grow."""
        x_new = torch.atleast_2d(_as_f32(x_new, self.device))
        y_new = torch.atleast_1d(_as_f32(y_new, self.device)).reshape(-1)
        if self._point_noise is None:
            self.X = torch.cat([self.X, x_new])
            self.Y = torch.cat([self.Y, y_new])
        else:
            cap = int(self.X.shape[0])
            self.X, self.Y = self.X.clone(), self.Y.clone()
            self._point_noise = self._point_noise.clone()
            for i in range(x_new.shape[0]):
                slot = self._ptr
                self.X[slot] = x_new[i]
                self.Y[slot] = y_new[i]
                self._point_noise[slot] = 0.0
                self._ptr += 1
                if self._ptr >= cap:
                    self._ptr = self._n0
        self._precompute()

    def real_data(self):
        """(X, Y) of the observed rows (the padding left out)."""
        if self._point_noise is None:
            return self.X, self.Y
        mask = self._point_noise == 0.0
        return self.X[mask], self.Y[mask]

    def state_dict(self):
        """numpy arrays and ints, the JAX package's layout."""
        sd = {'params': {k: v.detach().cpu().numpy() for k, v in self.params.items()},
              'X': self.X.cpu().numpy(), 'Y': self.Y.cpu().numpy()}
        if self._point_noise is not None:
            sd['point_noise'] = self._point_noise.cpu().numpy()
            sd['n0'] = self._n0
            sd['ptr'] = self._ptr
        return sd

    def load_state_dict(self, sd):
        """From :meth:`state_dict`'s layout, the port's or the JAX package's."""
        self.params = {k: _as_f32(v, self.device) for k, v in sd['params'].items()}
        self.X = _as_f32(sd['X'], self.device)
        self.Y = _as_f32(sd['Y'], self.device)
        if 'point_noise' in sd:
            self._point_noise = _as_f32(sd['point_noise'], self.device)
            self._n0 = int(sd['n0'])
            self._ptr = int(sd['ptr'])
        self._precompute()


class BatchGaussianProcess:
    """D output dimensions as one stack: every parameter has a leading (D,)
    axis, the inputs X (N, d) are shared, and training, the posterior's
    factors and prediction are batched over D. With test data, training
    keeps each dimension's iterate of the best held-out NLL."""

    def __init__(self, input_dim, target_dim, input_mask=None, target_mask=None,
                 kernel='Matern', device='cpu'):
        self.input_dim = int(input_dim)
        self.target_dim = int(target_dim)
        self.input_mask = input_mask
        self.target_mask = target_mask
        self.kernel_name = kernel
        self.kernel_fn = KERNELS[kernel]
        self.device = torch.device(device)
        self.params = _init_params((self.target_dim,), self.input_dim, self.device)
        self.X = None          # (N, d), shared across output dims
        self.Y = None          # (N, D)
        self._chol = None      # (D, N, N)
        self._alpha = None     # (D, N)

    def _apply_masks(self, X, Y=None):
        X = np.atleast_2d(np.asarray(X))
        if self.input_mask is not None:
            X = X[:, self.input_mask]
        if Y is None:
            return X
        Y = np.atleast_2d(np.asarray(Y))
        if self.target_mask is not None:
            Y = Y[:, self.target_mask]
        return X, Y

    def train(self, train_x, train_y, test_x=None, test_y=None, n_train=500,
              learning_rate=0.01, verbose=False, **kwargs):
        """Adam over all D dims at once; returns each dim's final training
        loss, or its best held-out NLL with test data."""
        train_x, train_y = self._apply_masks(train_x, train_y)
        X, Y = _as_f32(train_x, self.device), _as_f32(train_y, self.device)
        kernel_fn = self.kernel_fn
        track_fn = None
        if test_x is not None and test_y is not None:
            test_x, test_y = self._apply_masks(test_x, test_y)
            Xt, Yt = _as_f32(test_x, self.device), _as_f32(test_y, self.device)
            track_fn = lambda p: _nll(p, Xt, Yt.T, kernel_fn)
        self.params, losses = _adam_fit(self.params, lambda p: _nll(p, X, Y.T, kernel_fn),
                                        n_train, learning_rate, track_fn)
        self.X, self.Y = X, Y
        self._precompute()
        return [float(v) for v in losses.cpu().numpy()]

    @full_matmul_precision
    def _precompute(self):
        """The D factors of K + (noise + 1e-6) I and the alphas."""
        ls, sv, nv = _hyper(self.params)
        n = self.X.shape[0]
        K = self.kernel_fn(self.X, self.X, ls, sv) + (nv + 1e-6)[:, None, None] * _eye(n, self.X)
        self._chol = _cholesky(K)
        self._alpha = torch.cholesky_solve(self.Y.T[..., None], self._chol)[..., 0]

    def predict(self, x_star, return_pred=False):
        """Means and variances (n, D), numpy."""
        xs = _as_f32(self._apply_masks(x_star), self.device)
        ls, sv, _ = _hyper(self.params)
        means, variances = _stacked_gp_predict(self.X, self._chol, self._alpha, ls, sv, xs,
                                               self.kernel_fn)
        return means.T.cpu().numpy(), variances.T.cpu().numpy()

    def make_batched_predict_func(self):
        """The D posterior means z -> (D,) as a function of tensors."""
        X, alpha, kernel_fn = self.X, self._alpha, self.kernel_fn
        ls, sv, _ = _hyper(self.params)
        mask = (torch.as_tensor(self.input_mask, device=self.device)
                if self.input_mask is not None else None)

        @full_matmul_precision
        def mean_fn(z):
            zz = z.reshape(-1)
            if mask is not None:
                zz = zz[mask]
            return torch.sum(kernel_fn(zz[None], X, ls, sv)[:, 0] * alpha, dim=1)
        return mean_fn

    def state_dict(self):
        return {'params': {k: v.cpu().numpy() for k, v in self.params.items()},
                'X': self.X.cpu().numpy(), 'Y': self.Y.cpu().numpy()}

    def load_state_dict(self, sd):
        self.params = {k: _as_f32(v, self.device) for k, v in sd['params'].items()}
        self.X = _as_f32(sd['X'], self.device)
        self.Y = _as_f32(sd['Y'], self.device)
        self._precompute()


class GaussianProcessCollection:
    """One GP a target dimension, trained together (``vectorized``, through
    :class:`BatchGaussianProcess`) or one after another."""

    def __init__(self, model_type=None, likelihood=None, target_dim=1, input_mask=None,
                 target_mask=None, kernel='Matern', device='cpu', **kwargs):
        self.target_dim = target_dim
        self.input_mask = input_mask
        self.target_mask = target_mask
        self.kernel_name = kernel
        self.device = torch.device(device)
        self.gps = []

    def _masked(self, x, y):
        x, y = np.atleast_2d(np.asarray(x)), np.atleast_2d(np.asarray(y))
        if self.input_mask is not None:
            x = x[:, self.input_mask]
        if self.target_mask is not None:
            y = y[:, self.target_mask]
        return x, y

    def train(self, train_x, train_y, test_x=None, test_y=None, n_train=500,
              learning_rate=0.01, verbose=False, capacity=None, vectorized=True, **kwargs):
        """Train every per-dim GP; with ``capacity`` each reserves padded
        slots for online updates. Returns the per-dim losses."""
        train_x, train_y = self._masked(train_x, train_y)
        D = train_y.shape[1]
        self.gps = [GaussianProcess(train_x.shape[1], kernel=self.kernel_name,
                                    device=self.device) for _ in range(D)]
        if not vectorized:
            losses = [gp.train(train_x, train_y[:, d], n_train=n_train,
                               learning_rate=learning_rate)
                      for d, gp in enumerate(self.gps)]
        else:
            batch = BatchGaussianProcess(train_x.shape[1], D, kernel=self.kernel_name,
                                         device=self.device)
            if test_x is not None:
                test_x, test_y = self._masked(test_x, test_y)
            losses = batch.train(train_x, train_y, test_x=test_x, test_y=test_y,
                                 n_train=n_train, learning_rate=learning_rate)
            for d, gp in enumerate(self.gps):
                gp.params = {k: v[d] for k, v in batch.params.items()}
                gp.X, gp.Y = batch.X, batch.Y[:, d]
                gp._precompute()
        if capacity is not None:
            for gp in self.gps:
                gp.pad_capacity(int(capacity))
        return losses

    def stacked(self, fn):
        """The per-dim GPs' values of ``fn(gp)`` stacked on a leading (D,) axis."""
        return torch.stack([fn(gp) for gp in self.gps])

    def hyper(self):
        """Stacked length scales (D, d), signal and noise variances (D,)."""
        return tuple(self.stacked(lambda gp, i=i: _hyper(gp.params)[i]) for i in range(3))

    def predict(self, x_star, return_pred=False):
        """Means and variances (n, D) at full (x, u) rows, numpy; the input
        mask is applied here."""
        x_star = np.atleast_2d(np.asarray(x_star))
        if self.input_mask is not None:
            x_star = x_star[:, self.input_mask]
        ls, sv, _ = self.hyper()
        means, variances = _stacked_gp_predict(
            self.gps[0].X, self.stacked(lambda gp: gp._chol), self.stacked(lambda gp: gp._alpha),
            ls, sv, _as_f32(x_star, self.device), self.gps[0].kernel_fn)
        return means.T.cpu().numpy(), variances.T.cpu().numpy()

    def make_casadi_predict_func(self):
        """The D posterior means as one function z (d,) -> (D,) of tensors:
        the GPs share their inputs, so the means are one stacked kernel and
        one product."""
        X, kernel_fn = self.gps[0].X, self.gps[0].kernel_fn
        alphas = self.stacked(lambda gp: gp._alpha)
        ls, sv, _ = self.hyper()

        @full_matmul_precision
        def predict(z):
            k = kernel_fn(torch.atleast_2d(_as_f32(z, self.device)), X, ls, sv)[:, 0]
            return torch.sum(k * alphas, dim=1)
        return predict

    def make_fitc_predict_func(self, n_ind_points, rand_state=0):
        """The D FITC means as one function z (d,) -> (D,) over inducing
        points shared by the GPs (``kmeans_centriods`` of the observed
        inputs); returns the function and the inducing points (numpy)."""
        X = self.gps[0].real_data()[0].cpu().numpy()
        z_ind = kmeans_centriods(min(n_ind_points, X.shape[0]), X, rand_state=rand_state)
        Z = _as_f32(z_ind, self.device)
        ws = self.stacked(lambda gp: gp.fitc_weights(z_ind))
        ls, sv, _ = self.hyper()
        kernel_fn = self.gps[0].kernel_fn

        @full_matmul_precision
        def predict(z):
            k = kernel_fn(torch.atleast_2d(_as_f32(z, self.device)), Z, ls, sv)[:, 0]
            return torch.sum(k * ws, dim=1)
        return predict, z_ind

    def add_data(self, inputs, targets):
        """Add (input, target) rows to every per-dim GP (masks applied) and
        refresh their posteriors."""
        inputs, targets = self._masked(inputs, targets)
        for d, gp in enumerate(self.gps):
            gp.add_data(inputs, targets[:, d])

    def state_dict(self):
        return [gp.state_dict() for gp in self.gps]

    def load_state_dict(self, sds):
        """The GPs of a state dict list, the port's or the JAX package's
        (``GaussianProcessCollection.state_dict``: numpy arrays and ints)."""
        self.gps = []
        for sd in sds:
            gp = GaussianProcess(np.asarray(sd['X']).shape[1], kernel=self.kernel_name,
                                 device=self.device)
            gp.load_state_dict(sd)
            self.gps.append(gp)


@full_matmul_precision
def _stacked_gp_predict(X, chol, alpha, ls, sv, xs, kernel_fn):
    """Posterior means and variances (D, n) of D GPs sharing X."""
    k = kernel_fn(xs, X, ls, sv)                              # (D, n, N)
    mean = torch.sum(k * alpha[:, None, :], dim=2)
    v = torch.cholesky_solve(k.transpose(1, 2), chol)         # (D, N, n)
    return mean, sv[:, None] - torch.sum(k * v.transpose(1, 2), dim=2)


def lhs_sample(n_samples, lower, upper, rand_state=0):
    """Latin hypercube sampling over a box: one sample a stratum a
    dimension, randomly permuted (numpy, the JAX package's draws)."""
    lower = np.atleast_1d(np.asarray(lower, dtype=float))
    upper = np.atleast_1d(np.asarray(upper, dtype=float))
    d = lower.shape[0]
    rng = np.random.default_rng(rand_state)
    u = (rng.random((n_samples, d)) + np.arange(n_samples)[:, None]) / n_samples
    for j in range(d):
        u[:, j] = u[rng.permutation(n_samples), j]
    return lower + u * (upper - lower)


@full_matmul_precision
def lloyd_iterations(data, centroids, iters: int = 50):
    """``iters`` Lloyd steps from ``centroids`` (tensors): each point to its
    nearest centroid, each centroid to its points' mean (kept where it has
    none)."""
    n_cent = centroids.shape[0]
    for _ in range(iters):
        d = torch.sum((data[:, None, :] - centroids[None, :, :]) ** 2, dim=-1)
        one_hot = torch.nn.functional.one_hot(torch.argmin(d, dim=1), n_cent).to(data.dtype)
        counts = one_hot.sum(0)[:, None]
        sums = one_hot.T @ data
        centroids = torch.where(counts > 0, sums / torch.clamp(counts, min=1), centroids)
    return centroids


def kmeans_centriods(n_cent, data, rand_state=0, iters: int = 50):
    """Lloyd's k-means for inducing points, numpy in and out; the first
    centroids are ``n_cent`` distinct rows drawn by
    ``np.random.default_rng(rand_state)``."""
    data = torch.as_tensor(np.asarray(data, np.float32))
    idx = np.random.default_rng(rand_state).choice(data.shape[0], n_cent, replace=False)
    return lloyd_iterations(data, data[torch.as_tensor(idx)], iters).numpy()
