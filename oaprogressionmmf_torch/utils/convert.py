"""JAX variables ↔ the port's state dicts.

The JAX package keeps its weights as a ``{"params", "batch_stats"}`` tree
of arrays; the port's modules carry the reference's torch names. This is
the port's own copy of the naming logic of the JAX package's
``utils/torch_interop.py`` (``flax_fe_to_torch_seq``,
``flax_feat_to_torch``, ``export_reference_checkpoint``) and of the
inverses of its ``models/encoders.py`` converters (torchvision names for
SqueezeNet, VGG16, DenseNet-161 and Inception v3), producing torch
tensors; :func:`to_jax_variables` is its copy of the other direction
(``torch_seq_fe_to_flax``, ``torch_feat_to_flax``,
``import_reference_checkpoint`` and the JAX package's torchvision
importers), for every feature extractor, so the port writes bundles and
checkpoints the JAX package reads. :func:`load_quant_acts` and
:func:`quant_acts_tree` carry the int8 activation statistics between the
JAX ``quant_acts`` collection and the port's non-persistent site buffers.
The transposes and copies run in torch on the device of the tensors given
(numpy arrays are taken as CPU tensors); :func:`to_jax_variables` returns
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

# ResNet stages → indices in the FE's nn.Sequential(conv1, bn1, relu,
# maxpool, layer1..4)
_LAYER_TO_SEQ_IDX = {"layer1": 4, "layer2": 5, "layer3": 6, "layer4": 7}

# family → [(JAX subtree, torch prefix, kind)]
_FAMILY_LAYOUT = {
    "XR1Cnn": [("fe", "_fe", "fe"), ("agg_dense", "_agg.1", "dense"),
               ("final", "_final", "dense")],
    "MR1CnnTrf": [("fe", "_fe", "fe"), ("agg", "_agg", "feat")],
    "MR2CnnTrf": [("fe0", "_fe0", "fe"), ("fe1", "_fe1", "fe"),
                  ("agg", "_agg", "feat")],
    "XR1MR1CnnTrf": [("fe_xr", "_fe0", "fe"), ("fe_mr1", "_fe1", "fe"),
                     ("agg", "_agg", "feat")],
    "XR1MR2CnnTrf": [("fe_xr", "_fe0", "fe"), ("fe_mr1", "_fe1", "fe"),
                     ("fe_mr2", "_fe2", "fe"),
                     ("agg_1", "_agg_1", "feat"), ("agg_2", "_agg_2", "feat"),
                     ("agg_final", "_agg_final", "feat")],
    "XR1MR2C1CnnTrf": [("fe_xr", "_fe0", "fe"), ("fe_mr1", "_fe1", "fe"),
                       ("fe_mr2", "_fe2", "fe"), ("fe_clin", "_fe3", "clin"),
                       ("agg_1", "_agg_1", "feat"),
                       ("agg_2", "_agg_2", "feat"),
                       ("agg_final", "_agg_final", "feat")],
}

# torchvision `features` indices of the SqueezeNet Fires and VGG16 convs
_SQUEEZENET_FIRE_IDX = (3, 4, 5, 7, 8, 9, 10, 12)
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _host(a) -> torch.Tensor:
    """An array or tensor as a tensor, sharing its memory where it is
    writable (torch's copies and transposes run on all cores; numpy's
    on one)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _t(a) -> torch.Tensor:
    """Dense kernel (in, out) → Linear weight (out, in), a copy."""
    return _host(a).t().clone(memory_format=torch.contiguous_format)


def _conv(w) -> torch.Tensor:
    """Conv kernel (kh, kw, I/g, O) → (O, I/g, kh, kw), a copy."""
    return _host(w).permute(3, 2, 0, 1).clone(
        memory_format=torch.contiguous_format)


def _a(a) -> torch.Tensor:
    return _host(a).clone()


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _sub(tree, name):
    """``tree[name]``, or None where the tree or the entry is missing (an
    encoder without BatchNorm has no batch_stats)."""
    return None if tree is None else tree.get(name)


def _bn(sd: dict, src_p, src_s, dst: str) -> None:
    """A flax BatchNorm's scale/bias (and mean/var, unless ``src_s`` is
    None) → a torch BatchNorm2d's keys under ``dst``."""
    sd[f"{dst}.weight"] = _a(src_p["scale"])
    sd[f"{dst}.bias"] = _a(src_p["bias"])
    if src_s is None:
        return
    sd[f"{dst}.running_mean"] = _a(src_s["mean"])
    sd[f"{dst}.running_var"] = _a(src_s["var"])
    sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def _conv_b(sd: dict, src, dst: str) -> None:
    """A flax conv with bias → ``dst.weight`` and ``dst.bias``."""
    sd[f"{dst}.weight"] = _conv(src["kernel"])
    sd[f"{dst}.bias"] = _a(src["bias"])


def fe_state_dict(params: dict, stats: dict | None,
                  prefix: str = "") -> dict:
    """JAX ResNetFE params + batch_stats → ``models.resnet.ResNetFE`` keys.
    ``stats=None`` maps the parameters only."""
    sd: dict = {}
    sd[_join(prefix, "0.weight")] = _conv(params["conv1"]["kernel"])
    _bn(sd, params["bn1"], _sub(stats, "bn1"), _join(prefix, "1"))
    for name in sorted(params):
        if not name.startswith("layer"):
            continue
        layer, b = name.rsplit("_", 1)
        src_p, src_s = params[name], _sub(stats, name)
        dst = _join(prefix, f"{_LAYER_TO_SEQ_IDX[layer]}.{b}")
        ci = 0
        while f"Conv_{ci}" in src_p:
            sd[f"{dst}.conv{ci + 1}.weight"] = _conv(
                src_p[f"Conv_{ci}"]["kernel"])
            _bn(sd, src_p[f"BatchNorm_{ci}"], _sub(src_s, f"BatchNorm_{ci}"),
                f"{dst}.bn{ci + 1}")
            ci += 1
        if "downsample_conv" in src_p:
            sd[f"{dst}.downsample.0.weight"] = _conv(
                src_p["downsample_conv"]["kernel"])
            _bn(sd, src_p["downsample_bn"], _sub(src_s, "downsample_bn"),
                f"{dst}.downsample.1")
    return sd


def squeezenet_state_dict(params: dict, prefix: str = "") -> dict:
    """JAX SqueezeNetFE params → torchvision ``features.*`` keys (the
    inverse of the JAX package's ``convert_torch_squeezenet_state``)."""
    sd: dict = {}
    _conv_b(sd, params["conv1"], _join(prefix, "features.0"))
    for fi, pos in enumerate(_SQUEEZENET_FIRE_IDX):
        for sub in ("squeeze", "expand1x1", "expand3x3"):
            _conv_b(sd, params[f"fire{fi}"][sub],
                    _join(prefix, f"features.{pos}.{sub}"))
    return sd


def vgg_state_dict(params: dict, prefix: str = "") -> dict:
    """JAX VGGFE params → torchvision ``features.*`` keys (the inverse of
    ``convert_torch_vgg_state``)."""
    sd: dict = {}
    for ci, pos in enumerate(_VGG16_CONV_IDX):
        _conv_b(sd, params[f"conv{ci}"], _join(prefix, f"features.{pos}"))
    return sd


def densenet_state_dict(params: dict, stats: dict | None,
                        prefix: str = "") -> dict:
    """JAX DenseNetFE params + batch_stats → torchvision ``features.*``
    keys (the inverse of ``convert_torch_densenet_state``)."""
    sd: dict = {}
    f = _join(prefix, "features")
    sd[f"{f}.conv0.weight"] = _conv(params["conv0"]["kernel"])
    for name in sorted(params):
        src_p, src_s = params[name], _sub(stats, name)
        if name.startswith("denseblock"):
            block, layer = name.split("_")
            dst = f"{f}.{block}.dense{layer}"
            for i in (1, 2):
                _bn(sd, src_p[f"norm{i}"], _sub(src_s, f"norm{i}"),
                    f"{dst}.norm{i}")
                sd[f"{dst}.conv{i}.weight"] = _conv(
                    src_p[f"conv{i}"]["kernel"])
        elif name.startswith("transition"):
            block, part = name.split("_")
            if part == "norm":
                _bn(sd, src_p, src_s, f"{f}.{block}.norm")
            else:
                sd[f"{f}.{block}.conv.weight"] = _conv(src_p["kernel"])
        elif name.startswith("norm"):
            _bn(sd, src_p, src_s, f"{f}.{name}")
    return sd


def inception_state_dict(params: dict, stats: dict | None,
                         prefix: str = "") -> dict:
    """JAX InceptionV3FE params + batch_stats → torchvision keys
    (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.*``, ...; the
    inverse of ``convert_torch_inception_state``)."""
    sd: dict = {}

    def walk(src_p, src_s, dst):
        if "conv" in src_p and "bn" in src_p:    # a BasicConv2d
            sd[f"{dst}.conv.weight"] = _conv(src_p["conv"]["kernel"])
            _bn(sd, src_p["bn"], _sub(src_s, "bn"), f"{dst}.bn")
            return
        for name in src_p:
            walk(src_p[name], _sub(src_s, name), _join(dst, name))

    walk(params, stats, prefix)
    return sd


def any_fe_state_dict(params: dict, stats: dict | None,
                      prefix: str = "") -> dict:
    """Any JAX feature extractor → the port's keys; the encoder is told
    apart by its parameter names."""
    if "Conv2d_1a_3x3" in params:
        return inception_state_dict(params, stats, prefix)
    if "norm0" in params:
        return densenet_state_dict(params, stats, prefix)
    if "fire0" in params:
        return squeezenet_state_dict(params, prefix)
    if "conv0" in params:
        return vgg_state_dict(params, prefix)
    return fe_state_dict(params, stats, prefix)


def feat_state_dict(p: dict, prefix: str = "") -> dict:
    """JAX FeaT params → ``models.feat.FeaT`` keys; q, k and v kernels
    are concatenated into ``attn_{d}.to_qkv``."""
    sd: dict = {}

    def dense(src, dst):
        sd[f"{dst}.weight"] = _t(src["kernel"])
        sd[f"{dst}.bias"] = _a(src["bias"])

    def norm(src, dst):
        sd[f"{dst}.weight"] = _a(src["scale"])
        sd[f"{dst}.bias"] = _a(src["bias"])

    if "cls_token" in p:
        sd[_join(prefix, "cls_token")] = _a(p["cls_token"])
    sd[_join(prefix, "pos_embedding")] = _a(p["pos_embedding"])
    dense(p["patch_to_embedding"], _join(prefix, "patch_to_embedding"))
    tr = p["transformer"]
    tp = _join(prefix, "transformer")
    d = 0
    while f"prenorm_0_{d}" in tr:
        norm(tr[f"prenorm_0_{d}"], f"{tp}.prenorm_0_{d}")
        norm(tr[f"prenorm_1_{d}"], f"{tp}.prenorm_1_{d}")
        attn = tr[f"attn_{d}"]
        sd[f"{tp}.attn_{d}.to_qkv.weight"] = _t(torch.cat(
            [_host(attn[k]["kernel"]) for k in ("to_q", "to_k", "to_v")],
            dim=1))
        dense(attn["to_out"], f"{tp}.attn_{d}.to_out.0")
        dense(tr[f"ff_{d}"]["Dense_0"], f"{tp}.ff_{d}.net.0")
        dense(tr[f"ff_{d}"]["Dense_1"], f"{tp}.ff_{d}.net.3")
        d += 1
    i = 0
    while f"mlp_head{i}_norm" in p:
        hp = _join(prefix, f"mlp_head{i}")
        norm(p[f"mlp_head{i}_norm"], f"{hp}.0")
        dense(p[f"mlp_head{i}_dense0"], f"{hp}.1")
        dense(p[f"mlp_head{i}_dense1"], f"{hp}.4")
        i += 1
    return sd


def from_jax_variables(model_name: str, variables: dict) -> dict:
    """JAX ``{"params", "batch_stats"}`` numpy tree → the port's state
    dict for ``dict_models[model_name]``. Leaves may also be tensors: the
    transposes then run on their device.

    Without ``batch_stats`` only the parameters are mapped: that carries
    any tree of the parameters' structure across by name, e.g. optax's
    Adam moments ``mu`` and ``nu`` (``{"params": mu}``)."""
    if model_name not in _FAMILY_LAYOUT:
        raise KeyError(f"{model_name!r} is not ported; ported: "
                       f"{sorted(_FAMILY_LAYOUT)}")
    params = variables["params"]
    stats = variables.get("batch_stats")
    sd: dict = {}
    for subtree, prefix, kind in _FAMILY_LAYOUT[model_name]:
        if kind == "fe":
            sd.update(any_fe_state_dict(params[subtree],
                                        _sub(stats, subtree), prefix))
        elif kind == "feat":
            sd.update(feat_state_dict(params[subtree], prefix))
        elif kind == "clin":
            sd[f"{prefix}._fe.0.weight"] = _t(params[subtree]["fe"]["kernel"])
            sd[f"{prefix}._fe.0.bias"] = _a(params[subtree]["fe"]["bias"])
        elif kind == "dense":
            sd[f"{prefix}.weight"] = _t(params[subtree]["kernel"])
            sd[f"{prefix}.bias"] = _a(params[subtree]["bias"])
    return sd


# ---------------------------------------------------------------------------
# the port's state dict → JAX variables
# ---------------------------------------------------------------------------

_SEQ_IDX_TO_LAYER = {v: k for k, v in _LAYER_TO_SEQ_IDX.items()}


def _np(t) -> np.ndarray:
    """A tensor or array → a C-contiguous numpy array (bf16 widened to
    float32)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.numpy()
    return np.asarray(t, order="C")


def _t_np(w) -> np.ndarray:
    """Linear weight (out, in) → dense kernel (in, out); a tensor is
    transposed on its own device."""
    if isinstance(w, torch.Tensor):
        return _np(w.detach().t().contiguous())
    return np.ascontiguousarray(np.asarray(w).T)


def _conv_np(w) -> np.ndarray:
    """Conv weight (O, I/g, kh, kw) → kernel (kh, kw, I/g, O); a tensor is
    transposed on its own device."""
    if isinstance(w, torch.Tensor):
        return _np(w.detach().permute(2, 3, 1, 0).contiguous())
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _put(tree: dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _bn_variables(params: dict, stats: dict, sd: dict, path: tuple,
                  src: str) -> None:
    """A torch BatchNorm's keys under ``src`` → flax scale/bias (and
    mean/var where the state dict holds running statistics)."""
    _put(params, path + ("scale",), _np(sd[f"{src}.weight"]))
    _put(params, path + ("bias",), _np(sd[f"{src}.bias"]))
    if f"{src}.running_mean" in sd:
        _put(stats, path + ("mean",), _np(sd[f"{src}.running_mean"]))
        _put(stats, path + ("var",), _np(sd[f"{src}.running_var"]))


def _conv_variables(params: dict, sd: dict, path: tuple, src: str) -> None:
    """A torch conv's weight (and bias) → flax kernel (and bias)."""
    _put(params, path + ("kernel",), _conv_np(sd[f"{src}.weight"]))
    if f"{src}.bias" in sd:
        _put(params, path + ("bias",), _np(sd[f"{src}.bias"]))


def fe_variables(sd: dict, prefix: str) -> tuple[dict, dict]:
    """The port's ResNet FE keys under ``prefix`` → (flax params,
    batch_stats) of the JAX ResNetFE (``torch_seq_fe_to_flax``)."""
    params: dict = {}
    stats: dict = {}
    _conv_variables(params, sd, ("conv1",), f"{prefix}.0")
    _bn_variables(params, stats, sd, ("bn1",), f"{prefix}.1")
    for seq_idx, layer in _SEQ_IDX_TO_LAYER.items():
        b = 0
        while f"{prefix}.{seq_idx}.{b}.conv1.weight" in sd:
            src, dst = f"{prefix}.{seq_idx}.{b}", f"{layer}_{b}"
            ci = 0
            while f"{src}.conv{ci + 1}.weight" in sd:
                _conv_variables(params, sd, (dst, f"Conv_{ci}"),
                                f"{src}.conv{ci + 1}")
                _bn_variables(params, stats, sd, (dst, f"BatchNorm_{ci}"),
                              f"{src}.bn{ci + 1}")
                ci += 1
            if f"{src}.downsample.0.weight" in sd:
                _conv_variables(params, sd, (dst, "downsample_conv"),
                                f"{src}.downsample.0")
                _bn_variables(params, stats, sd, (dst, "downsample_bn"),
                              f"{src}.downsample.1")
            b += 1
    return params, stats


def squeezenet_variables(sd: dict, prefix: str) -> tuple[dict, dict]:
    """torchvision SqueezeNet 1.0 ``features.*`` keys → flax params (the
    inverse of :func:`squeezenet_state_dict`; no BatchNorm)."""
    params: dict = {}
    f = _join(prefix, "features")
    _conv_variables(params, sd, ("conv1",), f"{f}.0")
    for fi, pos in enumerate(_SQUEEZENET_FIRE_IDX):
        for sub in ("squeeze", "expand1x1", "expand3x3"):
            _conv_variables(params, sd, (f"fire{fi}", sub),
                            f"{f}.{pos}.{sub}")
    return params, {}


def vgg_variables(sd: dict, prefix: str) -> tuple[dict, dict]:
    """torchvision VGG16 ``features.*`` keys → flax params (the inverse of
    :func:`vgg_state_dict`; no BatchNorm)."""
    params: dict = {}
    for ci, pos in enumerate(_VGG16_CONV_IDX):
        _conv_variables(params, sd, (f"conv{ci}",),
                        _join(prefix, f"features.{pos}"))
    return params, {}


def _modules_under(sd: dict, prefix: str) -> list:
    """The module paths (without ``.weight``) of the weights under
    ``prefix``, in state-dict order."""
    head = _join(prefix, "")
    return [k[len(head):-len(".weight")] for k in sd
            if k.startswith(head) and k.endswith(".weight")]


def densenet_variables(sd: dict, prefix: str) -> tuple[dict, dict]:
    """torchvision DenseNet ``features.*`` keys → (flax params,
    batch_stats) (the inverse of :func:`densenet_state_dict`)."""
    params: dict = {}
    stats: dict = {}
    f = _join(prefix, "features")
    for mod in _modules_under(sd, f):
        parts = mod.split(".")
        if parts[0].startswith("denseblock"):      # denselayerL.normI/convI
            path = (f"{parts[0]}_{parts[1].removeprefix('dense')}",
                    parts[2])
        elif parts[0].startswith("transition"):    # norm or conv
            path = (f"{parts[0]}_{parts[1]}",)
        else:                                      # conv0, norm0, norm5
            path = (parts[0],)
        if np.ndim(sd[f"{f}.{mod}.weight"]) == 1:
            _bn_variables(params, stats, sd, path, f"{f}.{mod}")
        else:
            _conv_variables(params, sd, path, f"{f}.{mod}")
    return params, stats


def inception_variables(sd: dict, prefix: str) -> tuple[dict, dict]:
    """torchvision Inception v3 keys (``Mixed_5b.branch1x1.conv.weight``,
    ...) → (flax params, batch_stats) (the inverse of
    :func:`inception_state_dict`)."""
    params: dict = {}
    stats: dict = {}
    for mod in _modules_under(sd, prefix):
        path = tuple(mod.split("."))
        src = _join(prefix, mod)
        if path[-1] == "conv":
            _conv_variables(params, sd, path, src)
        else:
            _bn_variables(params, stats, sd, path, src)
    return params, stats


def any_fe_variables(sd: dict, prefix: str) -> tuple[dict, dict]:
    """Any of the port's feature extractors under ``prefix`` → (flax
    params, batch_stats); the encoder is told apart by its keys."""
    if f"{prefix}.4.0.conv1.weight" in sd:
        return fe_variables(sd, prefix)
    if f"{prefix}.Conv2d_1a_3x3.conv.weight" in sd:
        return inception_variables(sd, prefix)
    if f"{prefix}.features.conv0.weight" in sd:
        return densenet_variables(sd, prefix)
    if f"{prefix}.features.3.squeeze.weight" in sd:
        return squeezenet_variables(sd, prefix)
    return vgg_variables(sd, prefix)


def feat_variables(sd: dict, prefix: str) -> dict:
    """The port's FeaT keys under ``prefix`` → flax FeaT params
    (``torch_feat_to_flax``); ``to_qkv`` is split into the q, k and v
    kernels."""
    p: dict = {}

    def dense(src):
        out = {"kernel": _t_np(sd[f"{src}.weight"])}
        if f"{src}.bias" in sd:
            out["bias"] = _np(sd[f"{src}.bias"])
        return out

    def norm(src):
        return {"scale": _np(sd[f"{src}.weight"]),
                "bias": _np(sd[f"{src}.bias"])}

    if _join(prefix, "cls_token") in sd:
        p["cls_token"] = _np(sd[_join(prefix, "cls_token")])
    p["pos_embedding"] = _np(sd[_join(prefix, "pos_embedding")])
    p["patch_to_embedding"] = dense(_join(prefix, "patch_to_embedding"))
    tp = _join(prefix, "transformer")
    tr: dict = {}
    d = 0
    while f"{tp}.prenorm_0_{d}.weight" in sd:
        tr[f"prenorm_0_{d}"] = norm(f"{tp}.prenorm_0_{d}")
        tr[f"prenorm_1_{d}"] = norm(f"{tp}.prenorm_1_{d}")
        w_qkv = _t_np(sd[f"{tp}.attn_{d}.to_qkv.weight"])   # (d, 3d)
        dim = w_qkv.shape[0]
        tr[f"attn_{d}"] = {
            name: {"kernel": np.ascontiguousarray(
                w_qkv[:, i * dim:(i + 1) * dim])}
            for i, name in enumerate(("to_q", "to_k", "to_v"))}
        tr[f"attn_{d}"]["to_out"] = dense(f"{tp}.attn_{d}.to_out.0")
        tr[f"ff_{d}"] = {"Dense_0": dense(f"{tp}.ff_{d}.net.0"),
                         "Dense_1": dense(f"{tp}.ff_{d}.net.3")}
        d += 1
    p["transformer"] = tr
    i = 0
    while f"{_join(prefix, f'mlp_head{i}')}.0.weight" in sd:
        hp = _join(prefix, f"mlp_head{i}")
        p[f"mlp_head{i}_norm"] = norm(f"{hp}.0")
        p[f"mlp_head{i}_dense0"] = dense(f"{hp}.1")
        p[f"mlp_head{i}_dense1"] = dense(f"{hp}.4")
        i += 1
    return p


def to_jax_variables(model_name: str, state_dict: dict) -> dict:
    """The port's state dict (the reference's names) → the JAX
    ``{"params", "batch_stats"}`` numpy tree of ``model_name``; the inverse
    of :func:`from_jax_variables`, for every feature extractor.

    A state dict of the parameters only (no running statistics) maps to
    the parameters' tree and empty ``batch_stats``: that carries any tree
    of the parameters' structure across by name, e.g. an optimizer's
    moments."""
    if model_name not in _FAMILY_LAYOUT:
        raise KeyError(f"{model_name!r} is not ported; ported: "
                       f"{sorted(_FAMILY_LAYOUT)}")
    sd = dict(state_dict)
    params: dict = {}
    stats: dict = {}
    for subtree, prefix, kind in _FAMILY_LAYOUT[model_name]:
        if kind == "fe":
            params[subtree], fe_stats = any_fe_variables(sd, prefix)
            if fe_stats:        # BatchNorm-free encoders have no subtree
                stats[subtree] = fe_stats
        elif kind == "feat":
            params[subtree] = feat_variables(sd, prefix)
        elif kind == "clin":
            params[subtree] = {"fe": {
                "kernel": _t_np(sd[f"{prefix}._fe.0.weight"]),
                "bias": _np(sd[f"{prefix}._fe.0.bias"])}}
        elif kind == "dense":
            params[subtree] = {"kernel": _t_np(sd[f"{prefix}.weight"]),
                               "bias": _np(sd[f"{prefix}.bias"])}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# int8 activation statistics: JAX quant_acts ↔ the port's site buffers
# ---------------------------------------------------------------------------

def _fe_site_paths(local: str) -> list:
    """A ResNet FE site buffer (``amax_in.amax``, ``4.0.amax_1.amax``) →
    its JAX ``quant_acts`` path."""
    parts = local.split(".")[:-1]          # drop the buffer name "amax"
    if len(parts) == 1:
        return [tuple(parts)]
    seq, b, site = parts
    return [(f"{_SEQ_IDX_TO_LAYER[int(seq)]}_{b}", site)]


_FEAT_DENSES = {"to_out.0": "to_out", "net.0": "Dense_0",
                "net.3": "Dense_1"}


def _feat_site_paths(local: str) -> list:
    """A FeaT dense's ``amax`` buffer → its JAX ``quant_acts`` path(s): the
    fused ``to_qkv`` stands for three denses that see the same input."""
    parts = local.split(".")[:-1]
    if parts == ["patch_to_embedding"]:
        return [("patch_to_embedding", "amax")]
    if parts[0].startswith("mlp_head"):
        dense = {"1": "dense0", "4": "dense1"}[parts[1]]
        return [(f"{parts[0]}_{dense}", "amax")]
    block = parts[1]                       # transformer.<block>.<dense...>
    rest = ".".join(parts[2:])
    if rest == "to_qkv":
        return [("transformer", block, n, "amax")
                for n in ("to_q", "to_k", "to_v")]
    return [("transformer", block, _FEAT_DENSES[rest], "amax")]


def _site_buffers(model_name: str, model) -> list:
    """[(buffer, JAX paths)] of every activation site of ``model``."""
    if model_name not in _FAMILY_LAYOUT:
        raise KeyError(f"{model_name!r} is not ported")
    out = []
    for subtree, prefix, kind in _FAMILY_LAYOUT[model_name]:
        if kind not in ("fe", "feat"):
            continue
        module = model.get_submodule(prefix)
        for name, buf in module.named_buffers():
            if not name.endswith("amax"):
                continue
            local = (_fe_site_paths if kind == "fe" else _feat_site_paths)(
                name)
            out.append((buf, [(subtree,) + p for p in local]))
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def load_quant_acts(model_name: str, model, quant_acts: dict) -> None:
    """Copy a JAX ``quant_acts`` tree into ``model``'s site buffers,
    strictly: every site gets a value and every value a site. The three
    statistics of a fused ``to_qkv`` must be equal, as JAX's calibration
    records them."""
    given = {p: v for p, v in _leaves(quant_acts)}
    used = set()
    with torch.no_grad():
        for buf, paths in _site_buffers(model_name, model):
            missing = [p for p in paths if p not in given]
            if missing:
                raise KeyError(f"quant_acts lacks {'/'.join(missing[0])}")
            vals = {float(np.asarray(given[p], np.float32)) for p in paths}
            if len(vals) != 1:
                raise ValueError(f"quant_acts {'/'.join(paths[0][:-2])}: "
                                 f"to_q, to_k and to_v differ ({vals}); the "
                                 f"port's fused to_qkv takes one statistic")
            buf.fill_(vals.pop())
            used.update(paths)
    extra = sorted(set(given) - used)
    if extra:
        raise KeyError(f"quant_acts has {len(extra)} entries the model has "
                       f"no site for, e.g. {'/'.join(extra[0])}")


def quant_acts_tree(model_name: str, model) -> dict:
    """``model``'s site buffers → the JAX ``quant_acts`` tree (0-d float32
    arrays)."""
    tree: dict = {}
    for buf, paths in _site_buffers(model_name, model):
        for p in paths:
            _put(tree, p, np.asarray(buf.detach().cpu().float().item(),
                                     np.float32))
    return tree
