"""Patient-grouped stratified K-fold splitting.

The port's copy of ``oaprogressionmmf_tpu/utils/splits.py``.

Reimplements the greedy label-std-minimising StratifiedGroupKFold used by the
reference (koafusion/various/_stratified_group_kfold.py:83-119). Fold
membership must be bit-identical for identical seeds — the whole
checkpoint/prediction-parity story rests on reproducing the same folds —
so the algorithm below follows the same greedy assignment order:

  1. count per-group label histograms,
  2. optionally shuffle groups with `np.random.RandomState(seed)`,
  3. visit groups by descending std of their label histogram,
  4. assign each group to the fold that minimises the mean (over labels) of
     the std (over folds) of the label fraction.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np


class StratifiedGroupKFold:
    """Stratified K-fold with non-overlapping groups (greedy assignment)."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False,
                 random_state: int | None = None):
        if n_splits < 2:
            raise ValueError("n_splits must be >= 2")
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def _iter_test_indices(self, X, y, groups):
        y = np.asarray(y)
        labels_num = int(np.max(y)) + 1
        y_counts_per_group = defaultdict(lambda: np.zeros(labels_num))
        y_distr = Counter()
        for label, group in zip(y, groups):
            y_counts_per_group[group][label] += 1
            y_distr[label] += 1
        y_counts_per_fold = defaultdict(lambda: np.zeros(labels_num))
        groups_per_fold = defaultdict(set)

        groups_and_y_counts = list(y_counts_per_group.items())
        rng = np.random.RandomState(self.random_state)
        if self.shuffle:
            rng.shuffle(groups_and_y_counts)
        for group, y_counts in sorted(groups_and_y_counts,
                                      key=lambda x: -np.std(x[1])):
            best_fold = None
            min_eval = None
            for i in range(self.n_splits):
                y_counts_per_fold[i] += y_counts
                std_per_label = []
                for label in range(labels_num):
                    std_per_label.append(np.std(
                        [y_counts_per_fold[j][label] / y_distr[label]
                         for j in range(self.n_splits)]))
                y_counts_per_fold[i] -= y_counts
                fold_eval = np.mean(std_per_label)
                if min_eval is None or fold_eval < min_eval:
                    min_eval = fold_eval
                    best_fold = i
            y_counts_per_fold[best_fold] += y_counts
            groups_per_fold[best_fold].add(group)

        for i in range(self.n_splits):
            test_indices = [idx for idx, group in enumerate(groups)
                            if group in groups_per_fold[i]]
            yield test_indices

    def split(self, X, y, groups):
        """Yield (train_indices, test_indices) per fold."""
        n = len(groups)
        indices = np.arange(n)
        for test_idx in self._iter_test_indices(X, y, groups):
            test_mask = np.zeros(n, dtype=bool)
            test_mask[test_idx] = True
            yield indices[~test_mask], indices[test_mask]

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits
