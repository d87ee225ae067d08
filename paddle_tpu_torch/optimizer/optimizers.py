"""Concrete optimizers: the port of ``paddle_tpu/optimizer/optimizers.py``
(reference: python/paddle/optimizer/{sgd,momentum,adam,adamw,lamb,adagrad,
rmsprop,adadelta,adamax,asgd,rprop,radam,nadam,lbfgs}.py). Each update is
the reference's formula in torch ops on one parameter, computed in the
parameter's dtype (float32 from the master weight under
``multi_precision``), written in place (``Optimizer._apply_update``)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer, _in_dtype, _write


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        self._apply_update(p, val - self._lr_for(p) * gd)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        v = self._get_accumulator("velocity", p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        new_v = self._momentum * v._data.to(val.dtype) + gd
        _write(v, new_v)
        update = gd + self._momentum * new_v if self._nesterov else new_v
        self._apply_update(p, val - self._lr_for(p) * update)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill=1.0, shape=())
            self._add_accumulator("beta2_pow", p, fill=1.0, shape=())
            if self._amsgrad:
                self._add_accumulator("moment2_max", p)

    def _adam_update(self, p, g, decoupled_wd=None):
        val = self._param_value(p)
        cdt = val.dtype
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        gd = g._data.to(cdt)
        if decoupled_wd is None:
            gd = self._decayed(p, val, gd)
        b1, b2 = _in_dtype(self._beta1, cdt), _in_dtype(self._beta2, cdt)
        new_b1p = b1p._data.to(cdt) * b1
        new_b2p = b2p._data.to(cdt) * b2
        new_m1 = b1 * m1._data.to(cdt) + (1 - b1) * gd
        new_m2 = b2 * m2._data.to(cdt) + (1 - b2) * gd * gd
        _write(m1, new_m1)
        _write(m2, new_m2)
        _write(b1p, new_b1p)
        _write(b2p, new_b2p)
        mhat = new_m1 / (1 - new_b1p)
        denom_m2 = new_m2
        if self._amsgrad:
            mmax = self._get_accumulator("moment2_max", p)
            denom_m2 = torch.maximum(mmax._data.to(cdt), new_m2)
            _write(mmax, denom_m2)
        vhat = denom_m2 / (1 - new_b2p)
        lr = _in_dtype(self._lr_for(p), cdt)
        new_val = val - lr * mhat / (torch.sqrt(vhat) + self._epsilon)
        if decoupled_wd is not None:
            new_val = new_val - _in_dtype(lr * decoupled_wd, cdt) * val
        self._apply_update(p, new_val)

    def _append_optimize_op(self, p, g):
        self._adam_update(p, g)


class AdamW(Adam):
    """Decoupled weight decay (reference optimizer/adamw.py — fused
    adamw phi kernel at :495)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad, name)
        # a regularizer gives its coefficient to the decoupled decay
        self._wd = weight_decay if not hasattr(weight_decay, "coeff") \
            else float(weight_decay.coeff)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _append_optimize_op(self, p, g):
        wd = self._wd
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(p.name):
            wd = 0.0
        self._adam_update(p, g, decoupled_wd=float(wd))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("moment", p, fill=self._init_acc)

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        acc = self._get_accumulator("moment", p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        new_acc = acc._data.to(val.dtype) + gd * gd
        _write(acc, new_acc)
        self._apply_update(p, val - self._lr_for(p) * gd
                           / (torch.sqrt(new_acc) + self._epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum", p)
        new_ms = self._rho * ms._data.to(val.dtype) + \
            (1 - self._rho) * gd * gd
        _write(ms, new_ms)
        denom = new_ms
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            new_mg = self._rho * mg._data.to(val.dtype) + \
                (1 - self._rho) * gd
            _write(mg, new_mg)
            denom = new_ms - new_mg * new_mg
        new_mom = self._momentum * mom._data.to(val.dtype) + \
            self._lr_for(p) * gd / torch.sqrt(denom + self._epsilon)
        _write(mom, new_mom)
        self._apply_update(p, val - new_mom)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        new_asg = self._rho * asg._data.to(val.dtype) + \
            (1 - self._rho) * gd * gd
        update = -torch.sqrt(asu._data.to(val.dtype) + self._epsilon) / \
            torch.sqrt(new_asg + self._epsilon) * gd
        new_asu = self._rho * asu._data.to(val.dtype) + \
            (1 - self._rho) * update * update
        _write(asg, new_asg)
        _write(asu, new_asu)
        self._apply_update(p, val + self._lr_for(p) * update)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill=1.0, shape=())

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        m = self._get_accumulator("moment", p)
        u = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow", p)
        new_m = self._beta1 * m._data.to(val.dtype) + \
            (1 - self._beta1) * gd
        new_u = torch.maximum(self._beta2 * u._data.to(val.dtype),
                              torch.abs(gd))
        new_b1p = b1p._data.to(val.dtype) * self._beta1
        _write(m, new_m)
        _write(u, new_u)
        _write(b1p, new_b1p)
        self._apply_update(p, val - self._lr_for(p) / (1 - new_b1p) * new_m
                           / (new_u + self._epsilon))


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._wd = lamb_weight_decay
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill=1.0, shape=())
            self._add_accumulator("beta2_pow", p, fill=1.0, shape=())

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        cdt = val.dtype
        gd = g._data.to(cdt)
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        new_m1 = self._beta1 * m1._data.to(cdt) + (1 - self._beta1) * gd
        new_m2 = self._beta2 * m2._data.to(cdt) + \
            (1 - self._beta2) * gd * gd
        new_b1p = b1p._data.to(cdt) * self._beta1
        new_b2p = b2p._data.to(cdt) * self._beta2
        _write(m1, new_m1)
        _write(m2, new_m2)
        _write(b1p, new_b1p)
        _write(b2p, new_b2p)
        mhat = new_m1 / (1 - new_b1p)
        vhat = new_m2 / (1 - new_b2p)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        wd = 0.0 if (self._exclude_fn is not None
                     and self._exclude_fn(p)) else self._wd
        r = r + wd * val
        w_norm = torch.sqrt(torch.sum(val * val))
        r_norm = torch.sqrt(torch.sum(r * r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        self._apply_update(p, val - self._lr_for(p) * trust * r)


class ASGD(Optimizer):
    """Averaged SGD (reference optimizer/asgd.py — phi asgd kernel):
    keeps a running sum `d` of the last n gradients via a circular
    buffer `ys`; param -= lr * d / n."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._n = max(int(batch_num), 1)

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("d", p)
            self._add_accumulator("ys", p, shape=(self._n,)
                                  + tuple(p._data.shape))

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        d = self._get_accumulator("d", p)
        ys = self._get_accumulator("ys", p)
        idx = self._global_step % self._n
        new_d = d._data.to(val.dtype) - ys._data[idx].to(val.dtype) + gd
        _write(d, new_d)
        with torch.no_grad():
            ys._data[idx] = gd.to(ys._data.dtype)
        ys._version += 1
        n_eff = min(self._global_step + 1, self._n)
        self._apply_update(p, val - self._lr_for(p) * new_d / n_eff)


class Rprop(Optimizer):
    """Resilient backprop (reference optimizer/rprop.py): per-weight step
    sizes grown/shrunk by the sign agreement of successive gradients."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas
        self._initial_lr = float(learning_rate)

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("prev_grad", p)
            self._add_accumulator("step_size", p, fill=self._initial_lr)

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        gd = g._data.to(val.dtype)
        prev = self._get_accumulator("prev_grad", p)
        step = self._get_accumulator("step_size", p)
        sign = torch.sign(gd * prev._data.to(val.dtype))
        factor = torch.where(sign > 0, self._eta_pos,
                             torch.where(sign < 0, self._eta_neg, 1.0))
        new_step = torch.clamp(step._data.to(val.dtype) * factor,
                               self._lr_min, self._lr_max)
        # on sign change: zero the gradient (do not step through)
        eff_g = torch.where(sign < 0, 0.0, gd)
        _write(prev, eff_g)
        _write(step, new_step)
        self._apply_update(p, val - torch.sign(eff_g) * new_step)


class RAdam(Optimizer):
    """Rectified Adam (reference optimizer/radam.py): variance-rectified
    warmup of the adaptive term."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("m", p)
            self._add_accumulator("v", p)

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        m = self._get_accumulator("m", p)
        v = self._get_accumulator("v", p)
        b1, b2 = self._beta1, self._beta2
        t = self._global_step + 1
        new_m = b1 * m._data.to(val.dtype) + (1 - b1) * gd
        new_v = b2 * v._data.to(val.dtype) + (1 - b2) * gd * gd
        _write(m, new_m)
        _write(v, new_v)
        rho_inf = 2.0 / (1 - b2) - 1
        rho_t = rho_inf - 2.0 * t * b2 ** t / (1 - b2 ** t)
        m_hat = new_m / (1 - b1 ** t)
        lr = self._lr_for(p)
        if rho_t > 5.0:
            r = (((rho_t - 4) * (rho_t - 2) * rho_inf)
                 / ((rho_inf - 4) * (rho_inf - 2) * rho_t)) ** 0.5
            v_hat = torch.sqrt(new_v / (1 - b2 ** t)) + self._eps
            self._apply_update(p, val - lr * r * m_hat / v_hat)
        else:
            self._apply_update(p, val - lr * m_hat)


class NAdam(Optimizer):
    """Nesterov Adam (reference optimizer/nadam.py)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay
        self._mu_prod = 1.0

    def _create_accumulators(self):
        for p in self._parameter_list:
            self._add_accumulator("m", p)
            self._add_accumulator("v", p)

    def step(self):
        t = self._global_step + 1
        b1 = self._beta1
        self._mu_t = b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        self._mu_t1 = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        self._mu_prod_t = self._mu_prod * self._mu_t
        self._mu_prod_t1 = self._mu_prod_t * self._mu_t1
        super().step()
        self._mu_prod = self._mu_prod_t

    def _append_optimize_op(self, p, g):
        val = self._param_value(p)
        gd = self._decayed(p, val, g._data.to(val.dtype))
        m = self._get_accumulator("m", p)
        v = self._get_accumulator("v", p)
        b1, b2 = self._beta1, self._beta2
        t = self._global_step + 1
        new_m = b1 * m._data.to(val.dtype) + (1 - b1) * gd
        new_v = b2 * v._data.to(val.dtype) + (1 - b2) * gd * gd
        _write(m, new_m)
        _write(v, new_v)
        m_hat = (self._mu_t1 * new_m / (1 - self._mu_prod_t1)
                 + (1 - self._mu_t) * gd / (1 - self._mu_prod_t))
        v_hat = new_v / (1 - b2 ** t)
        self._apply_update(p, val - self._lr_for(p) * m_hat
                           / (torch.sqrt(v_hat) + self._eps))


class LBFGS(Optimizer):
    """L-BFGS with closure interface (reference optimizer/lbfgs.py):
    two-loop recursion over a bounded (s, y) history; step(closure)
    re-evaluates the loss."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._s, self._y = [], []
        self._prev_flat_g = None
        self._prev_loss = None

    def _flat_grad(self):
        # through the base class's plumbing, so that grad_clip and
        # weight_decay apply as in every other optimizer
        clipped = {id(p): g for p, g in self._grads()}
        gs = []
        for p in self._parameter_list:
            g = clipped.get(id(p))
            if g is None:
                gs.append(torch.zeros(p._data.numel(), dtype=torch.float32,
                                      device=p._data.device))
            else:
                gd = self._decayed(p, self._param_value(p),
                                   g._data.float())
                gs.append(gd.reshape(-1))
        return torch.cat(gs)

    def _flat_params(self):
        return torch.cat([p._data.detach().float().reshape(-1)
                          for p in self._parameter_list])

    def _set_flat_params(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p._data.numel()
            _write(p, flat[off:off + n].reshape(p._data.shape))
            off += n

    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure returning "
                             "the loss")
        loss = closure()
        with torch.no_grad():
            self._sync_lr()
            self._global_step += 1
            g = self._flat_grad()
            if float(torch.max(torch.abs(g))) <= self._tol_grad:
                return loss
            if self._prev_flat_g is not None:
                s = self._cur_step
                y = g - self._prev_flat_g
                if float(y @ s) > 1e-10:
                    self._s.append(s)
                    self._y.append(y)
                    if len(self._s) > self._history:
                        self._s.pop(0)
                        self._y.pop(0)
            # two-loop recursion
            q = g
            alphas = []
            for s, y in zip(reversed(self._s), reversed(self._y)):
                rho = 1.0 / float(y @ s)
                a = rho * float(s @ q)
                alphas.append((a, rho, s, y))
                q = q - a * y
            if self._s:
                gamma = float(self._s[-1] @ self._y[-1]) / \
                    float(self._y[-1] @ self._y[-1])
                q = q * gamma
            for a, rho, s, y in reversed(alphas):
                b = rho * float(y @ q)
                q = q + (a - b) * s
            self._cur_step = self._lr * -q
            self._set_flat_params(self._flat_params() + self._cur_step)
            self._prev_flat_g = g
        self.clear_grad()
        return loss
