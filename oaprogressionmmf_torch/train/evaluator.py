"""Evaluation runtime: fold-wise test predictions, the fold ensemble,
modality-ablation explanation and profiling.

Port of ``oaprogressionmmf_tpu/train/evaluator.py`` (the reference's
koafusion/run/eval_prog_fus.py:54-512):

  * each fold's last checkpoint (written by either package) → test-set
    predictions, pickled with keys {exam_knee_id, target, predict,
    predict_proba} and the JAX package's file names,
  * the fold ensemble: the mean of the folds' softmax probabilities, then
    a softmax again (the reference's double softmax,
    eval_prog_fus.py:335-340), joined without pandas,
  * metrics through ``calc_metrics_v2``, pickled fold-wise and for the
    ensemble,
  * the ``modal_abl`` explanation: per modality, attr =
    logit_target(x) − logit_target(x with that modality zeroed), the
    modality zeroed after the preprocessing (in the normalized space),
  * ``testing.quant=int8``: an int8-all model per fold, calibrated on the
    first rows of the first test batch,
  * ``testing.profile``: ``time`` (per-knee wall time), ``compute``
    (``FlopCounterMode``: matmuls and convolutions), ``trace``
    (``torch.profiler``).

Every model runs as :func:`~..serving.make_predictor` builds it: the
fold's float32 weights cast to ``runtime.compute_dtype`` on the device,
through the same kernels as a served request. Deliberate differences from
the JAX package: every ``time_per_sample*`` key is dropped before the
ensemble's join (the JAX package drops ``time_per_sample`` alone, so its
p50/p95 scalars become columns that the merge suffixes, and at five folds
it raises); ``profile=compute`` counts the FLOPs of matmuls and
convolutions, where XLA's cost analysis counts every operation;
``profile=trace`` writes a torch trace, the program's spans in it
(``tracing.py``); the JAX package's bf16 fast
downscale under ``testing.quant=int8`` is accepted and ignored.

The output lists hold Python ints, floats and strs only, so the pickles
load without torch.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..serving import (calibrate_quant_acts, make_predictor,
                       quantized_model_config)
from ..utils.checkpoint import load_model_variables, make_checkpoint_handler
from ..utils.convert import from_jax_variables
from ..utils.metrics import calc_metrics_v2
from .trainer import COMPUTE_DTYPES, ProgressionTrainer, _modality_xs

logger = logging.getLogger("eval")

# calibration of testing.quant=int8: the first rows of the first test batch
MAX_CALIB_BATCH = 16


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """``scipy.special.softmax``, term for term."""
    e = np.exp(x - np.amax(x, axis=axis, keepdims=True))
    return e / np.sum(e, axis=axis, keepdims=True)


def join_folds(raw_foldw: dict, renamed: tuple, dropped: tuple) -> dict:
    """The folds' raw dicts joined 1:1 on ``exam_knee_id``, as
    ``functools.reduce(pd.merge(..., on="exam_knee_id", validate="1:1"))``
    of the JAX package joins them: the rows whose knee every fold holds, in
    the first fold's order; the columns ``renamed`` as ``{name}__{fold}``;
    ``dropped`` kept from the first fold only; every ``time_per_sample*``
    key left out. Returns the columns in the merge's order."""
    key = "exam_knee_id"
    tables = []
    for i, (fold_idx, d) in enumerate(raw_foldw.items()):
        cols = {}
        for name, values in d.items():
            if name.startswith("time_per_sample") or (i and name in dropped):
                continue
            cols[f"{name}__{fold_idx}" if name in renamed else name] = \
                list(values)
        if len(set(cols[key])) != len(cols[key]):
            raise ValueError(f"fold {fold_idx}: exam_knee_id repeats; the "
                             f"join is 1:1")
        tables.append(cols)
    common = set(tables[0][key])
    for t in tables[1:]:
        common &= set(t[key])
    rows = [i for i, k in enumerate(tables[0][key]) if k in common]
    keys = [tables[0][key][i] for i in rows]
    out = {name: [values[i] for i in rows]
           for name, values in tables[0].items()}
    for t in tables[1:]:
        where = {k: i for i, k in enumerate(t[key])}
        for name, values in t.items():
            if name == key:
                continue
            if name in out:
                raise ValueError(f"column {name!r} in more than one fold")
            out[name] = [values[where[k]] for k in keys]
    return out


class ProgressionEvaluator:
    """Fold-wise evaluation over the (fold-independent) test subset.

    ``config`` is the config as a plain nested dict (``Config.to_dict()``);
    ``datasets`` as :class:`~.trainer.ProgressionTrainer` takes it. The
    models run on ``device``, the GPU unless ``device="cpu"``, in
    ``runtime.compute_dtype``.

    Under a process group each process evaluates its shard of the test
    set; the predictions are gathered in rank order and rank 0 writes the
    pickles."""

    def __init__(self, config: dict, *, device=None, datasets=None):
        self.config = config
        self.device = resolve_device(device)
        # the loaders of fold 0 only: the test subset is fold-independent
        # (eval_prog_fus.py:55-87); each fold's weights are restored here
        self.trainer = ProgressionTrainer(config, 0, device=self.device,
                                          datasets=datasets, resume=False)
        self.trainer.tb.close()
        self.modals = self.trainer.modals
        self.downscale = self.trainer.downscale
        self.model_cfg = config["model"]
        self.dtype = COMPUTE_DTYPES[
            (config.get("runtime") or {}).get("compute_dtype", "bfloat16")]
        root = Path(config["path_experiment_root"])
        self.path_weights = root / "weights"
        # logs subdir "incid"/"all" selects the knee cohort label as the
        # reference does (eval_prog_fus.py:81-85; T2-map experiments use
        # the incidence cohort)
        sel_knee = ("incid" if "sag_t2_map" in list(config["data"]
                                                     ["modals_all"])
                    else "all")
        self.path_logs = root / "logs_eval" / sel_knee
        self.path_logs.mkdir(parents=True, exist_ok=True)

        testing = config["testing"]
        if int(testing["folds"]["idx"]) == -1:
            self.fold_idcs = list(range(int(
                config["training"]["folds"]["num"])))
        else:
            self.fold_idcs = [int(testing["folds"]["idx"])]
        ignore = testing["folds"].get("ignore")
        if ignore:
            self.fold_idcs = [i for i in self.fold_idcs if i not in ignore]

        self.quant = str(testing.get("quant", "none") or "none")
        if self.quant not in ("none", "int8"):
            raise ValueError(f"testing.quant={self.quant!r}: use none|int8")
        self._quant_rt = (self._build_quant_runtime()
                          if self.quant == "int8" else None)

        if testing.get("describe_data", False):
            self.describe_data()

    def _build_quant_runtime(self) -> SimpleNamespace:
        """The model configs of ``testing.quant=int8``: the FE branches
        and the FeaT dense stacks quantized (serving's "int8-all"), and
        the calibration graph over the same sites."""
        return SimpleNamespace(
            calib_cfg=quantized_model_config(self.model_cfg, "calib"),
            int8_cfg=quantized_model_config(self.model_cfg, "int8-all"))

    def _predictor(self, state_dict: dict, model_cfg: dict | None = None,
                   quant_acts: dict | None = None):
        return make_predictor(model_cfg or self.model_cfg, state_dict,
                              self.modals, self.downscale,
                              device=self.device, dtype=self.dtype,
                              quant_acts=quant_acts)

    def _quant_predictor(self, state_dict: dict, xs):
        """Calibrate the activation scales on the first rows of ``xs``
        (the first test batch), then build the int8-all model."""
        calib = self._predictor(state_dict, self._quant_rt.calib_cfg)
        quant_acts = calibrate_quant_acts(calib, [xs], MAX_CALIB_BATCH)
        del calib
        return self._predictor(state_dict, self._quant_rt.int8_cfg,
                               quant_acts)

    def describe_data(self, subsets=("sel",)) -> dict:
        """Variable-distribution summary per subset
        (eval_prog_fus.py:89-134); needs the provider's data frames."""
        out = {}
        for subset in subsets:
            df = self.trainer.datasets[f"{subset}_df"]
            df_subj = df.drop_duplicates(subset=[("-", "patient")])
            summary = {
                "n_subjects": len(df_subj),
                "n_knees": len(df),
                "AGE": df_subj[("-", "AGE")].describe().to_dict(),
                "P01BMI": df_subj[("-", "P01BMI")].describe().to_dict(),
                "P02SEX": df_subj[("-", "P02SEX")].value_counts().to_dict(),
                "WOMTS-": df[("-", "WOMTS-")].describe().to_dict(),
                "XRKL": df[("-", "XRKL")].value_counts().to_dict(),
                "P01INJ-": df[("-", "P01INJ-")].value_counts().to_dict(),
                "P01KSURG-": df[("-", "P01KSURG-")].value_counts().to_dict(),
            }
            if ("-", "target") in df.columns:
                summary["target"] = df[("-", "target")].value_counts() \
                    .to_dict()
            logger.info(f"describe_data[{subset}]: {summary}")
            out[subset] = summary
        return out

    # ------------------------------------------------------------------

    def _restore_fold(self, fold_idx: int) -> dict:
        """The state dict of fold ``fold_idx``'s last checkpoint (its
        ``params`` and ``batch_stats``) under the reference's names, on
        the device."""
        path_fold = self.path_weights / "prog" / f"fold_{fold_idx}"
        handler = make_checkpoint_handler(
            path_fold,
            backend=self.config["training"].get("ckpt_backend", "msgpack"))
        path_ckpt = handler.get_last_ckpt()
        if path_ckpt is None:
            raise FileNotFoundError(f"No checkpoint in {path_fold}")
        return from_jax_variables(self.model_cfg["name"],
                                  load_model_variables(path_ckpt,
                                                       self.device))

    def eval_epoch(self, state_dict: dict) -> dict:
        """Test predictions of one fold's weights, with the optional
        time/compute/trace profiling (eval_prog_fus.py:250-317)."""
        acc: dict = {"exam_knee_id": [], "target": [], "predict": [],
                     "predict_proba": []}
        profile = self.config["testing"].get("profile", "none")
        predictor = (None if self._quant_rt is not None
                     else self._predictor(state_dict))

        prof = None
        if profile == "trace":
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            t_trace = time.time_ns()
            prof.__enter__()

        batch_times: list = []
        batch_valid: list = []
        warmed_up = False
        for batch in self.trainer.loaders["test"].epoch(0):
            xs = _modality_xs(batch, self.modals)
            ys = batch["target"][:, 0]
            n_valid = int(batch["_n_valid"])
            if predictor is None:
                # testing.quant=int8: calibrated on this (the first) batch,
                # which the quantized model then evaluates too
                predictor = self._quant_predictor(state_dict, xs)

            if profile == "compute":
                return self._profile_compute(predictor, xs, n_valid)

            if profile == "time" and not warmed_up:
                # the first batch once more, excluded from the timing (the
                # reference times steady-state batches)
                predictor(xs).cpu()
                warmed_up = True
            t0 = time.perf_counter()
            # the copy to the host is the completion barrier
            probs = predictor(xs).cpu().numpy()
            if profile == "time":
                batch_times.append(time.perf_counter() - t0)
                batch_valid.append(n_valid)

            probs = probs[:n_valid]
            acc["exam_knee_id"].extend(batch["exam_knee_id"][:n_valid])
            acc["target"].extend(np.asarray(ys)[:n_valid].tolist())
            acc["predict"].extend(np.argmax(probs, axis=1).tolist())
            acc["predict_proba"].extend(probs.tolist())

        if prof is not None:
            prof.__exit__(None, None, None)
            path = self.path_logs / "torch_trace"
            path.mkdir(parents=True, exist_ok=True)
            fn = path / f"eval_{len(list(path.glob('eval_*.json')))}.json"
            prof.export_chrome_trace(str(fn))
            tracing.add_to_chrome_trace(fn, [s for s in tracing.spans()
                                             if s.start_ns >= t_trace])
            logger.info(f"Wrote a torch.profiler trace to {fn}")
        if profile == "time" and batch_times:
            # per-knee latency = the batch's wall time / its valid knees
            # (padded work is charged to the real samples); p50/p95 over
            # batches
            per_knee = (np.asarray(batch_times) /
                        np.maximum(np.asarray(batch_valid), 1))
            acc["time_per_sample"] = float(np.mean(per_knee))
            acc["time_per_sample_p50"] = float(np.percentile(per_knee, 50))
            acc["time_per_sample_p95"] = float(np.percentile(per_knee, 95))
            logger.info(
                f"Inference time per sample: mean={np.mean(per_knee):.6f}s "
                f"p50={np.percentile(per_knee, 50):.6f}s "
                f"p95={np.percentile(per_knee, 95):.6f}s "
                f"({len(batch_times)} batches, warmup excluded)")
        return self._gathered(acc)

    def _gathered(self, acc: dict) -> dict:
        """Under a process group, every rank's rows in rank order (a scalar
        such as ``time_per_sample`` is rank 0's)."""
        dp = self.trainer.dp
        if dp is None:
            return acc
        parts = dp.all_gather_object(acc)
        return {k: sum((p[k] for p in parts), []) if isinstance(v, list)
                else v for k, v in acc.items()}

    def _write(self, path: Path, obj) -> None:
        """Rank 0 writes ``obj`` beside ``path`` and renames it into place,
        so that another rank checking the cache (``testing.use_cached``)
        finds the whole pickle or none."""
        if self.trainer.is_writer:
            tmp = path.with_name(f".{path.name}.tmp")
            tmp.write_bytes(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL))
            os.replace(tmp, path)

    def _profile_compute(self, predictor, xs, n_valid: int) -> dict:
        """FLOPs of one batch's forward (``FlopCounterMode``: matmuls and
        convolutions, 2 per multiply-add) and the parameter count."""
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            predictor(xs)
        flops = float(counter.get_total_flops())
        by_op = {str(op): int(n) for op, n in
                 counter.get_flop_counts().get("Global", {}).items()}
        n_params = sum(p.numel() for p in predictor.model.parameters())
        logger.info(f"FlopCounterMode: flops={flops:.3e} "
                    f"(~{flops / 2 / max(1, n_valid):.3e} MACs/sample) "
                    f"params={n_params:.3e}")
        return {"profile_compute": {"flops": flops, "flops_by_op": by_op},
                "num_params": int(n_params)}

    def ensemble_eval_foldw(self, raw_foldw: dict) -> dict:
        """The folds' predictions joined on exam_knee_id; the mean of their
        probabilities, then a softmax (eval_prog_fus.py:319-343)."""
        out = join_folds(raw_foldw, ("predict", "predict_proba"),
                         ("target",))
        cols = [c for c in out if c.startswith("predict_proba__")]
        # samples × folds × classes
        t = np.asarray([list(row) for row in zip(*(out[c] for c in cols))])
        t = softmax(np.mean(t, axis=1), axis=-1)
        out["predict_proba"] = t.tolist()
        out["predict"] = np.argmax(t, axis=-1).tolist()
        return out

    def _metrics(self, raw: dict) -> dict:
        return calc_metrics_v2(
            prog_target=np.asarray(raw["target"]),
            prog_pred_proba=np.asarray(raw["predict_proba"]),
            target=self.config["data"]["target"])

    def eval(self) -> dict:
        testing = self.config["testing"]
        paths_cache = {
            "raw_fold-w": self.path_logs / "eval_fus_raw_foldw.pkl",
            "raw_ens": self.path_logs / "eval_fus_raw_ens.pkl",
            "metrics_fold-w": self.path_logs / "eval_fus_metrics_foldw.pkl",
            "metrics_ens": self.path_logs / "eval_fus_metrics_ens.pkl",
        }
        use_cached = bool(testing.get("use_cached", False))

        if use_cached and paths_cache["raw_fold-w"].exists():
            raw_foldw = pickle.loads(paths_cache["raw_fold-w"].read_bytes())
        else:
            raw_foldw = {}
            for fold_idx in self.fold_idcs:
                raw_foldw[fold_idx] = self.eval_epoch(
                    self._restore_fold(fold_idx))
            self._write(paths_cache["raw_fold-w"], raw_foldw)

        results = {"raw_foldw": raw_foldw}

        if testing.get("metrics_foldw", True):
            metrics_foldw = {fold_idx: self._metrics(raw_foldw[fold_idx])
                             for fold_idx in self.fold_idcs
                             if fold_idx in raw_foldw}
            self._write(paths_cache["metrics_fold-w"], metrics_foldw)
            results["metrics_foldw"] = metrics_foldw
            for fold_idx, m in metrics_foldw.items():
                logger.info(f"Fold {fold_idx}: roc_auc={m['roc_auc']} "
                            f"avg_precision={m['avg_precision']}")

        if testing.get("ensemble_foldw", True) and raw_foldw:
            if use_cached and paths_cache["raw_ens"].exists():
                raw_ens = pickle.loads(paths_cache["raw_ens"].read_bytes())
            else:
                raw_ens = self.ensemble_eval_foldw(raw_foldw)
                self._write(paths_cache["raw_ens"], raw_ens)
            results["raw_ens"] = raw_ens

            if testing.get("metrics_ensemble", True):
                metrics_ens = self._metrics(raw_ens)
                self._write(paths_cache["metrics_ens"], metrics_ens)
                results["metrics_ens"] = metrics_ens
                logger.info(f"Ensemble: roc_auc={metrics_ens['roc_auc']} "
                            f"avg_precision={metrics_ens['avg_precision']}")
        return results

    # ------------------------------------------------------------------
    # Explanation: whole-modality ablation
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def explain_step(self, predictor, xs, ys) -> torch.Tensor:
        """(B, n_modals) float32 attributions: the target's logit less its
        logit with one modality zeroed in the preprocessed space; 1 +
        n_modals eval-mode forwards."""
        xs = predictor.preprocess(predictor.to_device(xs))
        idx = torch.as_tensor(ys).long().to(self.device)[:, None]

        def target_logit(inputs):
            out = predictor.model(*inputs)
            logits = (out["main"] if isinstance(out, dict) else out).float()
            return logits.gather(1, idx)[:, 0]

        base_t = target_logit(xs)
        attrs = [base_t - target_logit(tuple(
            torch.zeros_like(x) if i == m else x for i, x in enumerate(xs)))
            for m in range(len(xs))]
        return torch.stack(attrs, dim=1)

    def explain_epoch(self, state_dict: dict) -> dict:
        predictor = self._predictor(state_dict)
        acc: dict = {"exam_knee_id": [], "target": [], "modal_names": [],
                     "modal_abl_attrs": [], "modal_abl_percent": []}
        for batch in self.trainer.loaders["test"].epoch(0):
            xs = _modality_xs(batch, self.modals)
            ys = batch["target"][:, 0]
            n_valid = int(batch["_n_valid"])
            attrs = self.explain_step(predictor, xs, ys).cpu().numpy()
            attrs = attrs[:n_valid]
            norm = attrs / np.sum(np.abs(attrs), axis=1, keepdims=True)
            percent = np.round(np.abs(norm) * 100.0, decimals=3)

            acc["exam_knee_id"].extend(batch["exam_knee_id"][:n_valid])
            acc["target"].extend(np.asarray(ys)[:n_valid].tolist())
            acc["modal_names"].extend([list(self.modals)] * n_valid)
            acc["modal_abl_attrs"].extend(attrs.tolist())
            acc["modal_abl_percent"].extend(percent.tolist())
        return self._gathered(acc)

    def ensemble_explain_foldw(self, raw_foldw: dict) -> dict:
        """The folds' attributions joined on exam_knee_id; the mean of
        their percentages, normalized to sum to 1."""
        out = join_folds(raw_foldw, ("modal_abl_attrs", "modal_abl_percent"),
                         ("target", "modal_names"))
        cols = [c for c in out if c.startswith("modal_abl_percent__")]
        t = np.asarray([list(row) for row in zip(*(out[c] for c in cols))])
        t = np.mean(t, axis=1)
        t = t / np.sum(t, axis=1, keepdims=True)
        out["modal_abl_percent"] = t.tolist()
        return out

    def explain(self) -> dict:
        testing = self.config["testing"]
        if testing["explain_fn"] != "modal_abl":
            raise ValueError(f"Unknown explain_fn: {testing['explain_fn']}")
        paths_cache = {
            "raw_fold-w": self.path_logs / "explain_fus_raw_foldw.pkl",
            "raw_ens": self.path_logs / "explain_fus_raw_ens.pkl",
        }
        use_cached = bool(testing.get("use_cached", False))
        if use_cached and paths_cache["raw_fold-w"].exists():
            raw_foldw = pickle.loads(paths_cache["raw_fold-w"].read_bytes())
        else:
            raw_foldw = {}
            for fold_idx in self.fold_idcs:
                raw_foldw[fold_idx] = self.explain_epoch(
                    self._restore_fold(fold_idx))
            self._write(paths_cache["raw_fold-w"], raw_foldw)

        results = {"raw_foldw": raw_foldw}
        if testing.get("ensemble_foldw", True) and raw_foldw:
            raw_ens = self.ensemble_explain_foldw(raw_foldw)
            self._write(paths_cache["raw_ens"], raw_ens)
            results["raw_ens"] = raw_ens
        return results
