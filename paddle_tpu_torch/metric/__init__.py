"""paddle.metric: the port of ``paddle_tpu/metric/__init__.py``
(reference: python/paddle/metric/metrics.py). The metrics accumulate on
the host in numpy, as the reference's do; ``accuracy`` runs in tensor
ops."""
from __future__ import annotations

import numpy as np

from ..core.tensor import Tensor


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np = np.asarray(pred.numpy() if isinstance(pred, Tensor)
                             else pred)
        label_np = np.asarray(label.numpy() if isinstance(label, Tensor)
                              else label).reshape(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        correct = topk_idx == label_np[:, None]
        return correct

    def update(self, correct, *args):
        correct = np.asarray(correct)
        n = correct.shape[0]
        accs = []
        for i, k in enumerate(self.topk):
            c = correct[:, :k].any(axis=-1).sum()
            self.total[i] += float(c)
            self.count[i] += n
            accs.append(float(c) / n)
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.asarray(preds.numpy() if isinstance(preds, Tensor)
                           else preds).reshape(-1)
        labels = np.asarray(labels.numpy() if isinstance(labels, Tensor)
                            else labels).reshape(-1)
        pred_pos = (preds > 0.5).astype(int)
        self.tp += int(((pred_pos == 1) & (labels == 1)).sum())
        self.fp += int(((pred_pos == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.asarray(preds.numpy() if isinstance(preds, Tensor)
                           else preds).reshape(-1)
        labels = np.asarray(labels.numpy() if isinstance(labels, Tensor)
                            else labels).reshape(-1)
        pred_pos = (preds > 0.5).astype(int)
        self.tp += int(((pred_pos == 1) & (labels == 1)).sum())
        self.fn += int(((pred_pos == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds.numpy() if isinstance(preds, Tensor)
                           else preds)
        labels = np.asarray(labels.numpy() if isinstance(labels, Tensor)
                            else labels).reshape(-1)
        if preds.ndim == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        idx = np.minimum((preds * self.num_thresholds).astype(int),
                         self.num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over thresholds high→low
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    from .. import mean, topk
    vals, idx = topk(input, k)
    lab = label.reshape([-1, 1])
    correct_t = (idx == lab).any(axis=-1)
    return mean(correct_t.astype("float32"))
