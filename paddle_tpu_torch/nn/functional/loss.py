"""Loss functionals: the port of ``paddle_tpu/nn/functional/loss.py``
(reference: python/paddle/nn/functional/loss.py).

``cross_entropy`` keeps the reference's surface: ``ignore_index=-100``,
``soft_label``, ``axis``, ``weight``, ``reduction``, ``use_softmax``,
``label_smoothing`` and labels shaped [N] or [N, 1]. Hard labels go through
one ``torch.nn.functional.cross_entropy`` (the class axis moved to dim 1);
its "mean" is the sum over the kept labels divided by their count (or their
summed weights), clamped as the reference clamps it, so that a batch with
every label ignored gives 0 rather than 0/0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core.dispatch import run_op
from ...ops.math import jax_abs, jax_clip


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _masked_mean(total, valid, w=None):
    """The reference's "mean" over kept labels: sum / max(count, 1), or
    sum / max(sum of the kept weights, 1e-12) with a class weight."""
    if w is None:
        return total / valid.sum().clamp_min(1).to(total.dtype)
    return total / torch.where(valid, w, 0.0).sum().clamp_min(1e-12)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    def f(logits, lab, *maybe_w):
        ax = axis % logits.dim()
        w = maybe_w[0] if maybe_w else None
        soft = soft_label or (lab.dim() == logits.dim()
                              and lab.shape[ax] == logits.shape[ax]
                              and lab.is_floating_point())
        if soft or not use_softmax or (w is not None and (
                label_smoothing or w.requires_grad)):
            return _cross_entropy_decomposed(logits, lab, w, ax, soft,
                                             use_softmax, label_smoothing,
                                             ignore_index, reduction)
        if lab.dim() == logits.dim():
            lab = lab.squeeze(ax)
        lab = lab.long()
        moved = logits.movedim(ax, 1) if logits.dim() > 1 else logits
        red = "sum" if reduction == "mean" else reduction
        loss = tF.cross_entropy(moved, lab, weight=w,
                                ignore_index=ignore_index, reduction=red,
                                label_smoothing=label_smoothing)
        if reduction != "mean":
            return loss
        valid = lab != ignore_index
        return _masked_mean(loss, valid, None if w is None
                            else w[torch.where(valid, lab, 0)])
    extras = [weight] if weight is not None else []
    return run_op("cross_entropy", f, input, label, *extras)


def _cross_entropy_decomposed(logits, lab, w, ax, soft, use_softmax,
                              label_smoothing, ignore_index, reduction):
    """The reference's formula op by op: soft labels (smoothed toward
    uniform, weighted by sum(tgt * w)), probabilities instead of logits
    (use_softmax=False: log(max(p, 1e-30))), and a class weight together
    with label smoothing or one that takes a gradient (torch's
    cross_entropy does neither)."""
    logp = torch.log_softmax(logits, dim=ax) if use_softmax \
        else torch.log(torch.clamp_min(logits, 1e-30))
    if soft:
        tgt = lab
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt \
                + label_smoothing / logits.shape[ax]
        loss = -torch.sum(tgt * logp, dim=ax)
        if w is not None:
            loss = loss * torch.sum(tgt * w, dim=ax)
        return _reduce(loss, reduction)
    if lab.dim() == logits.dim():
        lab = lab.squeeze(ax)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = torch.take_along_dim(logp, safe.unsqueeze(ax), dim=ax).squeeze(ax)
    if label_smoothing > 0:
        picked = (1 - label_smoothing) * picked \
            + label_smoothing * torch.mean(logp, dim=ax)
    loss = -picked
    wt = None
    if w is not None:
        wt = w[safe]
        loss = loss * wt
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return _masked_mean(loss.sum(), valid, wt)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    from .activation import softmax as _softmax
    loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, _softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    def f(logp, lab, *maybe_w):
        w = maybe_w[0] if maybe_w else None
        lab = lab.long()
        if w is not None and w.requires_grad:
            # torch's nll_loss takes no gradient into its weight: op by op
            valid = lab != ignore_index
            safe = torch.where(valid, lab, 0)
            wt = w[safe]
            loss = torch.where(valid, -torch.take_along_dim(
                logp, safe.unsqueeze(1), dim=1).squeeze(1) * wt, 0.0)
            if reduction == "mean":
                return _masked_mean(loss.sum(), valid, wt)
            return _reduce(loss, reduction)
        red = "sum" if reduction == "mean" else reduction
        loss = tF.nll_loss(logp, lab, weight=w, ignore_index=ignore_index,
                           reduction=red)
        if reduction != "mean":
            return loss
        valid = lab != ignore_index
        return _masked_mean(loss, valid, None if w is None
                            else w[torch.where(valid, lab, 0)])
    extras = [weight] if weight is not None else []
    return run_op("nll_loss", f, input, label, *extras)


def mse_loss(input, label, reduction="mean", name=None):
    return run_op("mse_loss",
                  lambda a, b: _reduce(torch.square(a - b), reduction),
                  input, label)


def l1_loss(input, label, reduction="mean", name=None):
    return run_op("l1_loss",
                  lambda a, b: _reduce(jax_abs(a - b), reduction),
                  input, label)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    def f(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
        return _reduce(loss, reduction)
    return run_op("smooth_l1_loss", f, input, label)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    def f(a, b):
        d = torch.abs(a - b)
        loss = torch.where(d <= delta, 0.5 * d * d,
                           delta * (d - 0.5 * delta))
        return _reduce(loss, reduction)
    return run_op("huber_loss", f, input, label)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def f(p, y, *maybe_w):
        eps = 1e-12
        loss = -(y * torch.log(torch.clamp_min(p, eps))
                 + (1 - y) * torch.log(torch.clamp_min(1 - p, eps)))
        if maybe_w:
            loss = loss * maybe_w[0]
        return _reduce(loss, reduction)
    extras = [weight] if weight is not None else []
    return run_op("bce", f, input, label, *extras)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def f(z, y, *extras_arr):
        i = 0
        w = pw = None
        if weight is not None:
            w = extras_arr[i]
            i += 1
        if pos_weight is not None:
            pw = extras_arr[i]
        # softplus(z) - z*y: the reference's max(z,0) - z*y +
        # log1p(exp(-|z|)) in one smooth form, so the gradient at z = 0 is
        # sigmoid(0) - y (the kinks of max and abs give -y in the reference)
        base = tF.softplus(z) - z * y
        if pw is not None:
            base = -(pw * y * tF.logsigmoid(z) + (1 - y) * tF.logsigmoid(-z))
        if w is not None:
            base = base * w
        return _reduce(base, reduction)
    extras = [t for t in (weight, pos_weight) if t is not None]
    return run_op("bce_logits", f, logit, label, *extras)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def f(lp, t):
        tgt = torch.exp(t) if log_target else t
        logt = t if log_target else torch.log(torch.clamp_min(t, 1e-12))
        loss = tgt * (logt - lp)
        if reduction == "batchmean":
            return torch.sum(loss) / lp.shape[0]
        return _reduce(loss, reduction)
    return run_op("kl_div", f, input, label)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    def f(a, b, y):
        return _reduce(jax_clip(-y * (a - b) + margin, 0.0), reduction)
    return run_op("margin_ranking_loss", f, input, other, label)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    def f(a, y):
        loss = torch.where(y == 1, a, jax_clip(margin - a, 0.0))
        return _reduce(loss, reduction)
    return run_op("hinge_embedding_loss", f, input, label)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def f(a, b, y):
        cos = torch.sum(a * b, -1) / torch.clamp_min(
            torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1),
            1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin, 0.0))
        return _reduce(loss, reduction)
    return run_op("cosine_embedding_loss", f, input1, input2, label)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def f(a, pos, neg):
        def dist(u, v):
            return torch.pow(torch.sum(torch.pow(torch.abs(u - v) + epsilon,
                                                 p), -1), 1.0 / p)
        d_pos = dist(a, pos)
        d_neg = dist(a, neg)
        if swap:
            d_neg = torch.minimum(d_neg, dist(pos, neg))
        return _reduce(torch.clamp_min(d_pos - d_neg + margin, 0.0),
                       reduction)
    return run_op("triplet_margin_loss", f, input, positive, negative)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    def f(z, y, *maybe_w):
        loss = -(y * tF.logsigmoid(z) + (1 - y) * tF.logsigmoid(-z))
        if maybe_w:
            loss = loss * maybe_w[0]
        return _reduce(torch.mean(loss, -1), reduction)
    extras = [weight] if weight is not None else []
    return run_op("multi_label_soft_margin_loss", f, input, label, *extras)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return run_op("soft_margin_loss",
                  lambda z, y: _reduce(torch.log1p(torch.exp(-y * z)),
                                       reduction), input, label)


def square_error_cost(input, label):
    return run_op("square_error_cost",
                  lambda a, b: torch.square(a - b), input, label)


def log_loss(input, label, epsilon=1e-4, name=None):
    def f(p, y):
        return -y * torch.log(p + epsilon) \
            - (1 - y) * torch.log(1 - p + epsilon)
    return run_op("log_loss", f, input, label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def f(z, y, *maybe_n):
        p = torch.sigmoid(z)
        ce = tF.softplus(z) - z * y        # smooth at 0, as in bce

        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if maybe_n:
            loss = loss / maybe_n[0]
        return _reduce(loss, reduction)
    extras = [normalizer] if normalizer is not None else []
    return run_op("sigmoid_focal_loss", f, logit, label, *extras)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over log_softmax(log_probs) [T, B, C] (torch's forward
    algorithm); "mean" is the mean over the batch of each loss divided by
    its label length (at least 1), as the reference."""
    def f(lp, lab, in_len, lab_len):
        lp = torch.log_softmax(lp, dim=-1)
        loss = tF.ctc_loss(lp, lab.long(), in_len.long(), lab_len.long(),
                           blank=blank, reduction="none")
        if reduction == "mean":
            return torch.mean(loss / lab_len.clamp_min(1).to(loss.dtype))
        return _reduce(loss, reduction)
    return run_op("ctc_loss", f, log_probs, labels, input_lengths,
                  label_lengths)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    def f(a, p, y):
        sim = a @ p.T
        tgt = (y[:, None] == y[None, :]).to(a.dtype)
        tgt = tgt / torch.sum(tgt, -1, keepdim=True)
        ce = -torch.mean(torch.sum(tgt * torch.log_softmax(sim, -1), -1))
        reg = l2_reg * (torch.mean(torch.sum(a * a, -1))
                        + torch.mean(torch.sum(p * p, -1))) * 0.25
        return ce + reg
    return run_op("npair_loss", f, anchor, positive, labels)


def dice_loss(input, label, epsilon=1e-5, name=None):
    def f(p, y):
        yf = tF.one_hot(y.squeeze(-1).long(), p.shape[-1]).to(p.dtype)
        inter = torch.sum(p * yf, dim=-1)
        union = torch.sum(p, -1) + torch.sum(yf, -1)
        return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))
    return run_op("dice_loss", f, input, label)
