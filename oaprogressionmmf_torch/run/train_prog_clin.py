"""CLI: clinical-variable baselines (logistic regression and a decision
tree) — ``python -m oaprogressionmmf_torch.run.train_prog_clin``.

Port of ``oaprogressionmmf_tpu/run/train_prog_clin.py`` (the reference's
koafusion/run/train_prog_clin.py:63-267): the imaging provider's splits
(the same exclusions, the same site-D test subset, the same CV folds, so
that the baselines compare fairly with the fusion models), age, BMI and
WOMAC standardized, sex, KL, injury and surgery one-hot encoded, a grid
search or the stored best parameters, one estimator per fold, a
mean-probability test ensemble, and pickles in the eval app's schema.

scikit-learn on ~a thousand rows of a table: host work only, so
``main(argv)`` takes no device. scikit-learn and pandas are imported
inside the functions that use them.
"""

from __future__ import annotations

import logging
import pickle
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np

from . import app_config, as_tree

logger = logging.getLogger("train_prog_clin")

VAR_TO_COL = {
    "age": "AGE", "sex": "P02SEX", "bmi": "P01BMI", "kl": "XRKL",
    "inj": "P01INJ-", "surg": "P01KSURG-", "womac": "WOMTS-",
}

PARAM_GRIDS = {
    "LR": {"class_weight": [None, "balanced"]},
    "DT": {
        "max_depth": [3, 10, 30],
        "min_samples_split": [10, 30, 100, 300],
        "min_samples_leaf": [10, 30, 100],
        "max_features": [None, "sqrt", "log2"],
        "class_weight": [None, "balanced"],
    },
}

PREV_BEST = {
    "LR": {"class_weight": "balanced"},
    "DT": {"class_weight": "balanced", "max_depth": 10,
           "max_features": "log2", "min_samples_leaf": 100,
           "min_samples_split": 100},
}


def classifiers() -> dict:
    """The estimators by name, in the JAX package's order."""
    from sklearn import linear_model, tree

    return {"LR": linear_model.LogisticRegression,
            "DT": tree.DecisionTreeClassifier}


def _enc(enc, series):
    out = enc.transform(series.to_numpy().reshape(-1, 1))
    return out.toarray() if hasattr(out, "toarray") else out


def _feature_matrix(df, sel_vars, encoders):
    """[age, sex one-hot, bmi, (kl, inj, surg one-hots), (womac)]."""
    blocks = [_enc(encoders[v], df[VAR_TO_COL[v]])
              for v in ("age", "sex", "bmi")]
    for v in ("kl", "inj", "surg"):
        if v in sel_vars:
            blocks.append(_enc(encoders[v], df[VAR_TO_COL[v]]))
    if "womac" in sel_vars:
        blocks.append(_enc(encoders["womac"], df[VAR_TO_COL["womac"]]))
    return np.concatenate(blocks, axis=1)


class ClinicalBaseline:
    """The baselines of one experiment; ``config`` is the loaded
    ``prog_clin.yaml`` tree (a ``Config`` or a plain nested dict)."""

    def __init__(self, config):
        from ..data.provider import sources_from_path

        config = as_tree(config)
        self.config = config
        data = config["data"]
        sources = sources_from_path(
            path_data_root=config["path_data_root"],
            modals_all=data["modals_all"], target=data["target"],
            fold_num=config["training"]["folds"]["num"],
            scheme_train_val=config["scheme_train_val"],
            seed_trainval_test=config["seed_trainval_test"],
            seed_train_val=config["seed_train_val"],
            site_test=config["site_test"],
            ignore_cache=data["ignore_cache"])
        src = sources[data["sets"]["n0"]["name"]]
        self.df_trainval = src["trainval_df"]["-"]
        self.df_test = src["test_df"]["-"]
        self.folds = list(src["trainval_folds"])

        root = Path(config["path_experiment_root"])
        root.mkdir(exist_ok=True, parents=True)
        self.path_weights = root / "weights"
        self.path_weights.mkdir(exist_ok=True, parents=True)
        sel_knee = ("incid" if "sag_t2_map" in data["modals_all"]
                    else "all")
        self.path_logs = root / "logs_eval" / sel_knee
        self.path_logs.mkdir(exist_ok=True, parents=True)

    def _params(self, X, y) -> dict:
        """Each estimator's hyper-parameters: a grid search over the
        folds, or PREV_BEST."""
        from sklearn import model_selection

        cfg = self.config
        init = cfg["model"]["params_init"]
        if init == "prev_best":
            return {k: dict(v) for k, v in PREV_BEST.items()}
        if init != "grid_search":
            raise ValueError(f"Unknown `params_init`: {init}")
        params = {}
        for name, cls in classifiers().items():
            gs = model_selection.GridSearchCV(
                estimator=cls(), param_grid=PARAM_GRIDS[name],
                scoring=cfg["validation"]["criterion"],
                n_jobs=int(cfg.get("num_workers", 12)),
                cv=iter(self.folds), refit=False, return_train_score=True)
            gs.fit(X, y)
            params[name] = gs.best_params_
            logger.info(f"{name} best params: {gs.best_params_}")
        return params

    def fit(self) -> dict:
        """Fit the estimators per fold, ensemble their test
        probabilities, write ``logs_eval/<cohort>/eval_clin_raw_ens.pkl``
        and ``weights/<name>_all-folds.pkl``; returns what was written and
        the parameters."""
        from sklearn import model_selection, preprocessing

        cfg = self.config
        target = cfg["data"]["target"]
        sel_vars = list(cfg["model"]["vars"])
        encoders = {
            "age": preprocessing.StandardScaler(),
            "sex": preprocessing.OneHotEncoder(),
            "bmi": preprocessing.StandardScaler(),
            "kl": preprocessing.OneHotEncoder(),
            "inj": preprocessing.OneHotEncoder(),
            "surg": preprocessing.OneHotEncoder(),
            "womac": preprocessing.StandardScaler(),
        }
        for v, enc in encoders.items():
            enc.fit(self.df_trainval[VAR_TO_COL[v]].to_numpy().reshape(-1, 1))

        X_trainval = _feature_matrix(self.df_trainval, sel_vars, encoders)
        y_trainval = self.df_trainval[target].to_numpy()
        X_test = _feature_matrix(self.df_test, sel_vars, encoders)
        y_test = self.df_test[target].to_numpy()
        params = self._params(X_trainval, y_trainval)

        models = {}
        raw_ens = defaultdict(dict)
        n_folds = int(cfg["training"]["folds"]["num"])
        for name, cls in classifiers().items():
            cv_results = model_selection.cross_validate(
                estimator=cls(random_state=0, **params[name]),
                X=X_trainval, y=y_trainval,
                scoring=cfg["validation"]["criterion"],
                cv=iter(self.folds), n_jobs=int(cfg.get("num_workers", 12)),
                return_estimator=True)
            models[name] = cv_results["estimator"]
            logger.info(f"{name} OOF {cfg['validation']['criterion']}: "
                        f"{cv_results['test_score']}")

            cols = [VAR_TO_COL[v] for v in ("age", "sex", "bmi")]
            raw_ens[name] = self.df_test.loc[
                :, cols + ["exam_knee_id"]].to_dict(orient="list")
            proba_foldw = np.asarray([m.predict_proba(X_test)
                                      for m in models[name]])
            proba_mean = np.mean(proba_foldw, axis=0)
            for fold_idx in range(n_folds):
                raw_ens[name][f"predict_proba__{fold_idx}"] = \
                    proba_foldw[fold_idx]
                raw_ens[name][f"predict__{fold_idx}"] = \
                    np.argmax(proba_foldw[fold_idx], axis=1)
            raw_ens[name]["predict_proba"] = proba_mean
            raw_ens[name]["predict"] = np.argmax(proba_mean, axis=1)
            raw_ens[name]["target"] = y_test

        path_raw = self.path_logs / "eval_clin_raw_ens.pkl"
        path_raw.write_bytes(pickle.dumps(dict(raw_ens),
                                          pickle.HIGHEST_PROTOCOL))
        logger.info(f"Saved test predictions to {path_raw}")
        for name in models:
            path_model = self.path_weights / f"{name}_all-folds.pkl"
            path_model.write_bytes(pickle.dumps(models[name]))
            logger.info(f"Saved model {name} to {path_model}")
        return {"raw_ens": dict(raw_ens), "models": models, "params": params}


def run(config) -> dict:
    """Fit the baselines of ``config`` (a loaded ``prog_clin.yaml``)."""
    return ClinicalBaseline(config).fit()


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    with app_config(argv, "train_prog_clin.log",
                    conf_name="prog_clin.yaml") as config:
        return run(config)


if __name__ == "__main__":
    main()
