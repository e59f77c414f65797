"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py).

Weights are drawn with numpy from a seed into the shape tree of a JAX
module (``jax.eval_shape`` of its init: tracing only, no compile), so the
JAX module and its port see the same non-trivial values, BatchNorm
statistics included.
"""

import os

import numpy as np
import torch

import jax

# Under pytest-xdist every worker imports this module at collection. The
# workers share the machine's cores, and torch's default of one intra-op
# thread per core in each of them oversubscribes the cores (a port test
# ran 13x slower in a 6-worker run than alone): each worker takes its
# share instead.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _XDIST_WORKERS))

# the flagship family at test size (tests/test_models_families.py sizes,
# with a downscale so the eval preprocessing's resize runs)
FLAGSHIP_SMALL = {
    "name": "XR1MR2C1CnnTrf",
    "input_size": [[64, 64], [64, 64, 8], [64, 64, 2], [16]],
    "downscale": [[0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, 1.0], [1.0]],
    "input_channels": 1,
    "output_channels": 2,
    "output_type": "dict",
    "debug": False,
    "restore_weights": False,
    "fe": {
        "xr": {"arch": "resnet18", "pretrained": False, "with_gap": True,
               "dropout": 0.0},
        "mr": {"arch": "resnet18", "pretrained": False, "with_gap": True,
               "dropout": 0.0},
        "clin": {"dim_in": 9, "dim_out": 512, "dropout": 0.1},
    },
    "agg": {"num_slices": [1, 4, 2, 1], "depth": 1, "heads": 2,
            "emb_dropout": 0.1, "mlp_dim": 64, "mlp_dropout": 0.1},
}
FLAGSHIP_MODALS = ["xr_pa", "sag_3d_dess", "sag_t2_map", "clin"]


def synth_variables(init_fn, seed=0):
    """Fill the variable tree of ``init_fn()`` (a JAX module init) with
    numpy draws: BN scale and var in [0.5, 1.5], BN/dense biases and BN
    means small, kernels fan-in scaled, embeddings N(0, 1)."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        shape = leaf.shape
        if name in ("scale", "var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            arr = rng.normal(0.0, 0.1, shape)
        elif name in ("cls_token", "pos_embedding"):
            arr = rng.normal(0.0, 1.0, shape)
        else:
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)), shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flagship_raw_inputs(batch):
    """Raw per-modality inputs of FLAGSHIP_SMALL as the host ships them:
    uint8 XR and DESS, float T2 maps, float clinical values."""
    rng = np.random.RandomState(0)
    return (
        rng.randint(0, 256, (batch, 1, 64, 64), dtype=np.uint8),
        rng.randint(0, 256, (batch, 1, 64, 64, 8), dtype=np.uint8),
        rng.randint(0, 1000, (batch, 1, 64, 64, 2)).astype(np.float32)
        * 1e-4,
        rng.rand(batch, 1, 9).astype(np.float32),
    )


# the other five families at test size: resnet18 FEs, depth-1 FeaTs, uint8
# inputs downscaled by half in every extent
FAMILY_BATCH = 2
FAMILY_ATOL = 5e-4
FAMILY_AGG = {"depth": 1, "heads": 2, "emb_dropout": 0.1, "mlp_dim": 64,
              "mlp_dropout": 0.1}
FAMILY_FE = {"arch": "resnet18", "pretrained": False, "with_gap": True,
             "dropout": 0.0}
FAMILY_XR, FAMILY_DESS, FAMILY_TSE = (32, 32), (32, 32, 8), (32, 32, 4)
FAMILY_MODALS = {"XR1Cnn": ["xr_pa"], "MR1CnnTrf": ["sag_3d_dess"],
                 "MR2CnnTrf": ["sag_3d_dess", "cor_iw_tse"],
                 "XR1MR1CnnTrf": ["xr_pa", "sag_3d_dess"],
                 "XR1MR2CnnTrf": ["xr_pa", "sag_3d_dess", "cor_iw_tse"]}


def family_cfg(name, sizes, fe, agg):
    return {"name": name, "input_size": [list(s) for s in sizes],
            "downscale": [[0.5] * len(s) for s in sizes],
            "input_channels": 1, "output_channels": 2,
            "output_type": "dict", "debug": False, "restore_weights": False,
            "fe": fe, "agg": agg}


def mr_fe(dims_view="rc", with_gap=True):
    return dict(FAMILY_FE, dims_view=dims_view, with_gap=with_gap)


def check_predictor_against_jax(cfg):
    """The port's ``make_predictor`` (CPU, float32) on raw uint8 inputs
    against the JAX ``make_preprocess_fn(train=False)`` + ``apply`` +
    softmax on the same weights: probabilities and logits within
    FAMILY_ATOL."""
    import jax.numpy as jnp
    import torch

    from oaprogressionmmf_tpu.models import dict_models as jax_models
    from oaprogressionmmf_tpu.train.trainer import make_preprocess_fn
    from oaprogressionmmf_torch.serving import make_predictor
    from oaprogressionmmf_torch.utils.convert import from_jax_variables

    name = cfg["name"]
    rng = np.random.RandomState(0)
    xs = tuple(rng.randint(0, 256, (FAMILY_BATCH, 1) + tuple(s),
                           dtype=np.uint8) for s in cfg["input_size"])
    model = jax_models[name](config=cfg)
    preproc = make_preprocess_fn(FAMILY_MODALS[name], cfg["downscale"],
                                 train=False)
    inputs = preproc(tuple(jnp.asarray(x) for x in xs))
    variables = synth_variables(
        lambda: model.init(jax.random.key(0), *inputs, train=False), seed=7)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, xs: model.apply(v, *preproc(xs),
                                                train=False))(
            variables, tuple(jnp.asarray(x) for x in xs))
    want_logits = np.asarray(out["main"])
    want = np.asarray(jax.nn.softmax(want_logits, axis=-1))

    predictor = make_predictor(cfg, from_jax_variables(name, variables),
                               FAMILY_MODALS[name], cfg["downscale"],
                               device="cpu", dtype=torch.float32)
    probs = predictor(xs)
    assert probs.dtype == torch.float32
    assert probs.shape == (FAMILY_BATCH, 2)
    np.testing.assert_allclose(probs.numpy(), want, atol=FAMILY_ATOL)
    np.testing.assert_allclose(predictor.logits(xs).numpy(), want_logits,
                               atol=FAMILY_ATOL)
    # the inputs reach the logits: the knees differ
    assert np.abs(want_logits[0] - want_logits[1]).max() > 1e-3


def jax_augment_draws(key, modals, batch):
    """The augmentation draws of one JAX train step with ``key``
    (oaprogressionmmf_tpu/train/trainer.py:137,269-270; ops/preproc.py:
    145-167), per modality (None for ``clin``), as the port's
    ``AugmentDraws``: the port is handed what JAX draws."""
    import math

    import torch

    from oaprogressionmmf_torch.ops.preproc import AugmentDraws

    lo, hi = math.radians(-15.0), math.radians(15.0)
    k_aug, _ = jax.random.split(key)
    draws = []
    for i, m in enumerate(modals):
        if m == "clin":
            draws.append(None)
            continue
        cols = [[], [], [], []]
        for k in jax.random.split(jax.random.fold_in(k_aug, i), batch):
            k_rotp, k_theta, k_gp, k_gamma = jax.random.split(k, 4)
            for col, v in zip(cols, (
                    jax.random.uniform(k_rotp, ()),
                    jax.random.uniform(k_theta, (), minval=lo, maxval=hi),
                    jax.random.uniform(k_gp, ()),
                    jax.random.uniform(k_gamma, (), minval=0.5,
                                       maxval=2.0))):
                col.append(float(v))
        draws.append(AugmentDraws(*(torch.tensor(c) for c in cols)))
    return draws


def assert_percent_close(got_pct, want_pct, got_attr, want_attr):
    """Explain percentages |a_i| / Σ|a| · 100 (rounded to 3 places) of
    two runs whose attributions differ by δ in a row: held to the
    first-order bound 100 · (1 + n) · δ / Σ|a| of that row, plus the
    rounding (1e-3)."""
    got_pct, want_pct = np.asarray(got_pct), np.asarray(want_pct)
    got_attr, want_attr = np.asarray(got_attr), np.asarray(want_attr)
    n = want_attr.shape[1]
    delta = np.abs(got_attr - want_attr).max(axis=1, keepdims=True)
    bound = 100 * (1 + n) * delta / np.abs(want_attr).sum(
        axis=1, keepdims=True) + 1e-3
    assert (np.abs(got_pct - want_pct) <= bound).all(), \
        (np.abs(got_pct - want_pct).max(), bound.min())
    return bound
