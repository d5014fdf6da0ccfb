"""Node-classification evaluation, the DeepWalk/TopKRanker protocol (a copy
of ``graphtpu/eval/f1.py``).

Exact reimplementation of ``node2vec/src/classify.py:155-255``:

  * features = embedding rows for nodes 1..N (``classify.py:192``)
  * 3 shuffles x train fractions 0.1..0.9 (``classify.py:196-206``)
  * OneVsRest L2 LogisticRegression; at predict time each node gets
    exactly k labels where k = its true label count, taken from the top of
    predict_proba (``TopKRanker.predict``, ``classify.py:155-164``)
  * micro/macro F1 over the multi-label sets (``classify.py:243-246``)

sklearn runs host-side (it's evaluation, not the compute path).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


def _top_k_predict(clf, x_test: np.ndarray, top_k_list: Sequence[int]):
    probs = np.asarray(clf.predict_proba(x_test))
    out = []
    for i, k in enumerate(top_k_list):
        idx = probs[i].argsort()[-k:] if k > 0 else np.array([], dtype=int)
        out.append(clf.classes_[idx].tolist())
    return out


def _to_multihot(label_lists, n_classes: int) -> np.ndarray:
    y = np.zeros((len(label_lists), n_classes), dtype=np.int8)
    for i, labs in enumerate(label_lists):
        for l in labs:
            y[i, int(l)] = 1
    return y


def topk_ranker_scoring(
    features: np.ndarray,
    label_lists: List[List[int]],
    n_classes: int,
    train_fractions: Optional[Sequence[float]] = None,
    n_shuffles: int = 3,
    seed: int = 0,
    verbose: bool = False,
) -> Dict[float, List[Dict[str, float]]]:
    """Returns {train_fraction: [{'micro':..,'macro':..} per shuffle]}."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import f1_score
    from sklearn.multiclass import OneVsRestClassifier

    if train_fractions is None:
        train_fractions = (np.arange(1, 10) * 0.1).tolist()

    n = features.shape[0]
    rng = np.random.default_rng(seed)
    shuffles = [rng.permutation(n) for _ in range(n_shuffles)]
    results: Dict[float, List[Dict[str, float]]] = defaultdict(list)

    for frac in train_fractions:
        for perm in shuffles:
            split = int(frac * n)
            tr, te = perm[:split], perm[split:]
            y_train = [label_lists[i] for i in tr]
            y_test = [label_lists[i] for i in te]
            clf = OneVsRestClassifier(LogisticRegression(penalty="l2", max_iter=500))
            clf.fit(features[tr], _to_multihot(y_train, n_classes))
            preds = _top_k_predict(clf, features[te], [len(l) for l in y_test])
            yt = _to_multihot(y_test, n_classes)
            yp = _to_multihot(preds, n_classes)
            res = {
                "micro": float(f1_score(yt, yp, average="micro")),
                "macro": float(f1_score(yt, yp, average="macro")),
            }
            results[float(round(frac, 2))].append(res)
            if verbose:
                print(f"train {frac:.1f}: micro {res['micro']:.4f} macro {res['macro']:.4f}")
    return dict(results)


def scoring_from_emb_file(
    emb_path: str, mat_path: str, **kwargs
) -> Dict[float, List[Dict[str, float]]]:
    """The reference ``scoring()`` flow (``classify.py:173-255``): load a
    word2vec-format .emb plus the BlogCatalog .mat, nodes labelled 1..N."""
    from graphtpu_torch.io.embfile import read_emb_dict
    from graphtpu_torch.io.matfile import load_blogcatalog, labels_to_lists

    emb = read_emb_dict(emb_path)
    _, group = load_blogcatalog(mat_path)
    n = group.shape[0]
    feats = np.stack([emb[str(i)] for i in range(1, n + 1)])
    return topk_ranker_scoring(
        feats, labels_to_lists(group), group.shape[1], **kwargs
    )
