"""Plain float32 reference of the benchmark's progression models.

Written from the paper's description (Panfilov et al., "Predicting knee
osteoarthritis progression from structural MRI using deep learning",
IEEE JBHI 2025) and the reference implementation's module layout, in plain
``torch`` operations on a dict of tensors under the reference's state-dict
names: no kernel, cache or module of the measured program. The models:

* ResNet v1.5 feature extractors (stride on the 3x3 conv; ResNeXt50-32x4d
  with grouped 3x3 convs), BatchNorm eps 1e-5, global average pooling;
* FeaT: a linear patch embedding, an optional CLS token, a learned
  positional embedding, pre-LN blocks of bias-free fused-QKV attention and
  an exact-GELU MLP, an MLP head on the first token;
* ``MR1CnnTrf`` (DESS slices → ResNet50 → CLS FeaT) and ``XR1MR2C1CnnTrf``
  (X-ray → ResNeXt50, DESS and T2 slices → two ResNet50s and two CLS-less
  FeaTs, a clinical token, a final CLS FeaT).

A feature extractor that ``ARCHS`` lacks is found by its name in
``fe/<arch>.py`` beside this file: ``spec(prefix)`` (its state-dict
entries as :func:`param_spec` lists them), ``WIDTH`` (its output width)
and ``forward(x, p, prefix, train, prec, remat)`` → (N, WIDTH), built on
:func:`conv`, :func:`linear` and :func:`batch_norm` so that a control's
:class:`Precision` reaches it. A family outside ``FAMILIES`` is found
in ``families/<name>.py``: ``param_spec(cfg)``, ``token_counts(cfg)`` and
``forward`` as :func:`forward` takes it.

Departures from the paper's description, all shared with the reference
implementation:

* a grayscale image meets the ImageNet RGB stem through the kernel summed
  over its three input channels, which equals repeating the image three
  times;
* attention scores are scaled by the model width ``dim ** -0.5``, not the
  head width;
* the per-MRI FeaTs of the fusion model carry an MLP head whose output is
  never used (its parameters get no gradient from the loss).

``Precision`` puts the inputs and weights of every convolution and linear
layer through a lower precision for the benchmark's control runs; its
default is float32 and changes nothing. ``Masks`` draws a training step's
dropout masks from the seed, so that the program, given the same masks,
can be compared step for step.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.harness import load_module

HERE = Path(__file__).resolve().parent

# arch → (block, blocks per stage, groups, base width, output channels)
ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1, 64, 512),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64, 2048),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4, 2048),
}
BN_EPS = 1e-5
LN_EPS = 1e-5
# the lower precisions of the controls: fp8 (e4m3), and integers of
# that many levels either side of 0
LEVELS = {"fp8": None, "int8": 127, "int4": 7}
# those in which a model is computed, its activations and gradients held
# there (int4 stands for int8 serving, whose epilogues stay float32)
HELD = ("fp8", "int8")
# the families this file defines; any other is found by name
FAMILIES = ("MR1CnnTrf", "XR1MR2C1CnnTrf")


@functools.cache
def by_name(kind: str, name: str):
    """The reference ``<kind>/<name>.py`` beside this file: a feature
    extractor (``fe``) or a family (``families``) defined outside it."""
    return load_module(HERE / kind / f"{name}.py")


# ---------------------------------------------------------------- precision

class Precision:
    """What a convolution or linear layer sees of its inputs and weights.

    ``"float32"``: the values themselves. ``"fp8"``: each tensor scaled by
    its largest magnitude onto float8 e4m3's range (448) and rounded there.
    ``"int8"``/``"int4"``: activations rounded onto 255/15 symmetric levels
    of one scale per tensor, weights onto one scale per output channel.
    The rounding passes gradients through unchanged (straight-through).
    In fp8 and int8 the values a layer hands on are held there too
    (:meth:`out`: outputs of convolutions, linear layers, residual sums
    and attention weights), and so are the gradients that flow back
    through them, as a model computed in that precision holds them; in
    int4, as in int8 serving, the epilogues stay float32."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", *LEVELS):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    @staticmethod
    def _through(x, xq):
        return x + (xq - x).detach() if x.requires_grad else xq

    def _round(self, x, per_channel: bool):
        if self.name == "float32":
            return x
        dims = tuple(range(1, x.dim())) if per_channel else None
        amax = (x.detach().abs().amax(dim=dims, keepdim=True) if dims
                else x.detach().abs().max()).clamp_min(1e-12)
        return self._through(x, _rounded(x.detach(), self.name, amax))

    def act(self, x):
        return self._round(x, per_channel=False)

    def out(self, y):
        if self.name not in HELD:
            return y
        y = self._round(y, per_channel=False)
        return _GradRound.apply(y, self.name) if y.requires_grad else y

    def weight(self, w):
        return self._round(w, per_channel=self.name == "int4")


FLOAT32 = Precision()


def _rounded(t, name: str, amax=None):
    """``t`` rounded onto ``name``'s grid, scaled by ``amax`` (one
    scale per tensor where it is None)."""
    if amax is None:
        amax = t.abs().max().clamp_min(1e-30)
    if name == "fp8":
        scale = amax / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
    scale = amax / LEVELS[name]
    return torch.round(t / scale).clamp(-LEVELS[name], LEVELS[name]) * scale


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient rounded onto the precision's grid
    (one scale per tensor) on its way back."""

    @staticmethod
    def forward(ctx, y, name):
        ctx.name = name
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, ctx.name), None


# ---------------------------------------------------------------- dropout

class Masks:
    """The dropout masks of one training step, drawn from the seed: the
    ``i``-th dropout of the step with rate ``p`` keeps the elements (in
    their flattened order) where a uniform draw of a generator seeded by
    (seed, step, i) on the tensor's device is at least ``p``, and scales
    them by 1/(1 − p). The calls are counted in the order of the model's
    forward pass; a dropout of rate 0 is no call."""

    def __init__(self, seed: int, step: int):
        self.seed, self.step, self.calls = int(seed), int(step), 0

    def keep(self, x, p: float):
        gen = torch.Generator(device=x.device).manual_seed(
            (self.seed * 1_000_003 + self.step * 10_007 + self.calls)
            % 2 ** 63)
        self.calls += 1
        return (torch.rand(x.numel(), generator=gen, device=x.device)
                >= p).view(x.shape)

    def __call__(self, x, p: float):
        """As torch's dropout: the product in float32, rounded once to
        ``x``'s type."""
        return (x.float() * self.keep(x, p) * (1.0 / (1.0 - p))).to(x.dtype)


def _drop(drop, x, p: float):
    return x if drop is None or not p else drop(x, p)


# ---------------------------------------------------------------- parameters

def _bn_spec(prefix: str, c: int) -> list:
    return [(f"{prefix}weight", (c,), "one"), (f"{prefix}bias", (c,), "zero"),
            (f"{prefix}running_mean", (c,), "zero"),
            (f"{prefix}running_var", (c,), "one"),
            (f"{prefix}num_batches_tracked", (), "count")]


def _blocks(arch: str):
    """(stage, block, in channels, width, out channels, stride, groups) of
    every residual block of ``arch``."""
    kind, stages, groups, base_width, _ = ARCHS[arch]
    expansion = 4 if kind == "bottleneck" else 1
    in_ch = 64
    for i, n in enumerate(stages):
        filters = 64 * 2 ** i
        width = (int(filters * base_width / 64) * groups
                 if kind == "bottleneck" else filters)
        out = filters * expansion
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            yield i, j, in_ch, width, out, stride, groups
            in_ch = out


def resnet_spec(prefix: str, arch: str) -> list:
    """(name, shape, kind) of every tensor of a feature extractor."""
    kind = ARCHS[arch][0]
    spec = [(f"{prefix}0.weight", (64, 3, 7, 7), "w")] + _bn_spec(
        f"{prefix}1.", 64)
    for i, j, cin, width, out, stride, groups in _blocks(arch):
        p = f"{prefix}{4 + i}.{j}."
        if kind == "bottleneck":
            spec += [(f"{p}conv1.weight", (width, cin, 1, 1), "w"),
                     *_bn_spec(f"{p}bn1.", width),
                     (f"{p}conv2.weight", (width, width // groups, 3, 3),
                      "w"),
                     *_bn_spec(f"{p}bn2.", width),
                     (f"{p}conv3.weight", (out, width, 1, 1), "w"),
                     *_bn_spec(f"{p}bn3.", out)]
        else:
            spec += [(f"{p}conv1.weight", (width, cin, 3, 3), "w"),
                     *_bn_spec(f"{p}bn1.", width),
                     (f"{p}conv2.weight", (out, width, 3, 3), "w"),
                     *_bn_spec(f"{p}bn2.", out)]
        if stride != 1 or cin != out:
            spec += [(f"{p}downsample.0.weight", (out, cin, 1, 1), "w"),
                     *_bn_spec(f"{p}downsample.1.", out)]
    return spec


def fe_spec(prefix: str, arch: str) -> list:
    """(name, shape, kind) of every tensor of the feature extractor."""
    return (resnet_spec(prefix, arch) if arch in ARCHS
            else by_name("fe", arch).spec(prefix))


def fe_width(arch: str) -> int:
    return ARCHS[arch][4] if arch in ARCHS else by_name("fe", arch).WIDTH


def _linear_spec(prefix: str, d_in: int, d_out: int, bias=True) -> list:
    spec = [(f"{prefix}weight", (d_out, d_in), "w")]
    return spec + ([(f"{prefix}bias", (d_out,), "zero")] if bias else [])


def _ln_spec(prefix: str, d: int) -> list:
    return [(f"{prefix}weight", (d,), "one"), (f"{prefix}bias", (d,), "zero")]


def feat_spec(prefix: str, n_patches: int, dim: int, agg: dict,
              classes: int, with_cls: bool) -> list:
    depth, mlp = int(agg["depth"]), int(agg["mlp_dim"])
    spec = _linear_spec(f"{prefix}patch_to_embedding.", dim, dim)
    if with_cls:
        spec.append((f"{prefix}cls_token", (1, 1, dim), "tok"))
    spec.append((f"{prefix}pos_embedding",
                 (1, n_patches + int(with_cls), dim), "tok"))
    for d in range(depth):
        t = f"{prefix}transformer."
        spec += [*_ln_spec(f"{t}prenorm_0_{d}.", dim),
                 *_linear_spec(f"{t}attn_{d}.to_qkv.", dim, 3 * dim, False),
                 *_linear_spec(f"{t}attn_{d}.to_out.0.", dim, dim),
                 *_ln_spec(f"{t}prenorm_1_{d}.", dim),
                 *_linear_spec(f"{t}ff_{d}.net.0.", dim, mlp),
                 *_linear_spec(f"{t}ff_{d}.net.3.", mlp, dim)]
    return spec + [*_ln_spec(f"{prefix}mlp_head0.0.", dim),
                   *_linear_spec(f"{prefix}mlp_head0.1.", dim, mlp),
                   *_linear_spec(f"{prefix}mlp_head0.4.", mlp, classes)]


def _scaled(size, factor) -> list:
    return [round(s * f) for s, f in zip(size, factor or [1.0] * len(size))]


def token_counts(cfg: dict) -> dict:
    """Tokens of each FeaT of a model config."""
    if cfg["name"] not in FAMILIES:
        return by_name("families", cfg["name"]).token_counts(cfg)
    ds = cfg.get("downscale") or [None] * len(cfg["input_size"])
    if cfg["name"] == "MR1CnnTrf":
        return {"_agg.": _scaled(cfg["input_size"][0], ds[0])[2]}
    ns = cfg["agg"]["num_slices"]
    return {"_agg_1.": ns[1], "_agg_2.": ns[2],
            "_agg_final.": ns[0] + ns[1] + ns[2] + ns[3]}


def param_spec(cfg: dict) -> list:
    """(name, shape, kind) of every tensor of the model's state dict, in a
    fixed order; ``kind`` says how :func:`make_weights` fills it."""
    if cfg["name"] not in FAMILIES:
        return by_name("families", cfg["name"]).param_spec(cfg)
    classes = int(cfg["output_channels"])
    tokens = token_counts(cfg)
    if cfg["name"] == "MR1CnnTrf":
        arch = cfg["fe"]["arch"]
        dim = fe_width(arch)
        return (fe_spec("_fe.", arch)
                + feat_spec("_agg.", tokens["_agg."], dim, cfg["agg"],
                            classes, True))
    xr, mr = cfg["fe"]["xr"]["arch"], cfg["fe"]["mr"]["arch"]
    dim = fe_width(mr)
    return (fe_spec("_fe0.", xr) + fe_spec("_fe1.", mr)
            + fe_spec("_fe2.", mr)
            + feat_spec("_agg_1.", tokens["_agg_1."], dim, cfg["agg"],
                        classes, False)
            + feat_spec("_agg_2.", tokens["_agg_2."], dim, cfg["agg"],
                        classes, False)
            + feat_spec("_agg_final.", tokens["_agg_final."], dim,
                        cfg["agg"], classes, True)
            + _linear_spec("_fe3._fe.0.", int(cfg["fe"]["clin"]["dim_in"]),
                           dim))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The model's float32 state dict from ``seed``, on ``device``: norm
    scales and variances 1, biases and means 0, every other tensor normal
    with standard deviation 1/√fan_in (a weight's input width; the leading
    extents of a CLS token or positional embedding). All normals come from
    one call of a ``torch.Generator`` on ``device``."""
    spec = param_spec(cfg)
    n = sum(math.prod(s) for _, s, k in spec if k in ("w", "tok"))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    normals = torch.randn(n, generator=gen, device=device)
    sd, at = {}, 0
    for name, shape, kind in spec:
        if kind == "count":
            sd[name] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in ("one", "zero"):
            sd[name] = (torch.ones if kind == "one" else torch.zeros)(
                shape, device=device)
        else:
            size = math.prod(shape)
            fan_in = math.prod(shape[:-1] if kind == "tok" else shape[1:])
            sd[name] = normals[at:at + size].view(shape).mul_(
                1.0 / math.sqrt(max(fan_in, 1)))
            at += size
    return sd


# ---------------------------------------------------------------- layers

def conv(x, w, stride=1, padding=0, groups=1, prec=FLOAT32):
    return prec.out(F.conv2d(prec.act(x), prec.weight(w), None, stride,
                             padding, 1, groups))


def linear(x, w, b=None, prec=FLOAT32):
    y = prec.act(x) @ prec.weight(w).t()
    return prec.out(y if b is None else y + b)


def batch_norm(x, p: dict, prefix: str, train: bool):
    """Over the batch's statistics (biased variance) in training, the
    running ones in eval."""
    if train:
        return F.batch_norm(x, None, None, p[f"{prefix}weight"],
                            p[f"{prefix}bias"], True, 0.0, BN_EPS)
    return F.batch_norm(x, p[f"{prefix}running_mean"],
                        p[f"{prefix}running_var"], p[f"{prefix}weight"],
                        p[f"{prefix}bias"], False, 0.0, BN_EPS)


def layer_norm(x, p: dict, prefix: str):
    return F.layer_norm(x, x.shape[-1:], p[f"{prefix}weight"],
                        p[f"{prefix}bias"], LN_EPS)


def _block(x, p, prefix, kind, stride, groups, train, prec):
    if kind == "bottleneck":
        y = F.relu(batch_norm(conv(x, p[f"{prefix}conv1.weight"], prec=prec),
                              p, f"{prefix}bn1.", train))
        y = F.relu(batch_norm(conv(y, p[f"{prefix}conv2.weight"], stride, 1,
                                   groups, prec), p, f"{prefix}bn2.", train))
        y = batch_norm(conv(y, p[f"{prefix}conv3.weight"], prec=prec), p,
                       f"{prefix}bn3.", train)
    else:
        y = F.relu(batch_norm(conv(x, p[f"{prefix}conv1.weight"], stride, 1,
                                   prec=prec), p, f"{prefix}bn1.", train))
        y = batch_norm(conv(y, p[f"{prefix}conv2.weight"], 1, 1, prec=prec),
                       p, f"{prefix}bn2.", train)
    if f"{prefix}downsample.0.weight" in p:
        x = batch_norm(conv(x, p[f"{prefix}downsample.0.weight"], stride,
                            prec=prec), p, f"{prefix}downsample.1.", train)
    return prec.out(F.relu(y + x))


def _stem(x, p, prefix, train, prec):
    w = p[f"{prefix}0.weight"].sum(dim=1, keepdim=True)
    x = F.relu(batch_norm(conv(x, w, 2, 3, prec=prec), p, f"{prefix}1.",
                          train))
    return F.max_pool2d(x, 3, 2, 1)


def resnet(x, p: dict, prefix: str, arch: str, train: bool = False,
           prec=FLOAT32, remat: bool = False):
    """(N, 1, H, W) images → (N, C) pooled features. ``remat`` recomputes
    each block's activations in the backward pass instead of keeping
    them, the stem's too (the same numbers, less memory)."""
    kind = ARCHS[arch][0]
    x = (checkpoint(_stem, x, p, prefix, train, prec, use_reentrant=False)
         if remat else _stem(x, p, prefix, train, prec))
    for i, j, _, _, _, stride, groups in _blocks(arch):
        args = (p, f"{prefix}{4 + i}.{j}.", kind, stride, groups, train,
                prec)
        x = (checkpoint(_block, x, *args, use_reentrant=False) if remat
             else _block(x, *args))
    return x.mean(dim=(2, 3))


def fe_forward(x, p: dict, prefix: str, arch: str, train: bool = False,
               prec=FLOAT32, remat: bool = False):
    """(N, 1, H, W) images through the feature extractor ``arch`` → (N, C)
    features."""
    if arch in ARCHS:
        return resnet(x, p, prefix, arch, train, prec, remat)
    return by_name("fe", arch).forward(x, p, prefix, train, prec, remat)


def feat(tokens, p: dict, prefix: str, heads: int, prec=FLOAT32,
         drop=None, rates=(0.0, 0.0)):
    """(B, N, C) tokens → (head output (B, classes), states (B, N', C)).
    ``drop``: a training step's :class:`Masks`, with ``rates`` the
    embedding's and the blocks' and head's dropout rates."""
    emb_p, mlp_p = rates
    b, _, dim = tokens.shape
    x = linear(tokens, p[f"{prefix}patch_to_embedding.weight"],
               p[f"{prefix}patch_to_embedding.bias"], prec)
    if f"{prefix}cls_token" in p:
        x = torch.cat([p[f"{prefix}cls_token"].expand(b, -1, -1), x], dim=1)
    x = _drop(drop, x + p[f"{prefix}pos_embedding"], emb_p)
    n, dh, t = x.shape[1], dim // heads, f"{prefix}transformer."
    d = 0
    while f"{t}attn_{d}.to_qkv.weight" in p:
        o = layer_norm(x, p, f"{t}prenorm_0_{d}.")
        qkv = linear(o, p[f"{t}attn_{d}.to_qkv.weight"], prec=prec)
        q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        att = prec.out(torch.softmax((q @ k.transpose(-1, -2)) * dim ** -0.5,
                                     dim=-1))
        o = (att @ v).transpose(1, 2).reshape(b, n, dim)
        x = prec.out(x + _drop(drop, linear(
            o, p[f"{t}attn_{d}.to_out.0.weight"],
            p[f"{t}attn_{d}.to_out.0.bias"], prec), mlp_p))
        o = layer_norm(x, p, f"{t}prenorm_1_{d}.")
        o = _drop(drop, F.gelu(linear(o, p[f"{t}ff_{d}.net.0.weight"],
                                      p[f"{t}ff_{d}.net.0.bias"], prec)),
                  mlp_p)
        x = prec.out(x + _drop(drop, linear(
            o, p[f"{t}ff_{d}.net.3.weight"], p[f"{t}ff_{d}.net.3.bias"],
            prec), mlp_p))
        d += 1
    h = layer_norm(x[:, 0], p, f"{prefix}mlp_head0.0.")
    h = _drop(drop, F.gelu(linear(h, p[f"{prefix}mlp_head0.1.weight"],
                                  p[f"{prefix}mlp_head0.1.bias"], prec)),
              mlp_p)
    out = linear(h, p[f"{prefix}mlp_head0.4.weight"],
                 p[f"{prefix}mlp_head0.4.bias"], prec)
    return out, x


def _slices(volume):
    """(B, 1, R, C, S) → (B·S, 1, R, C), the slices of each knee in order."""
    b, _, r, c, s = volume.shape
    return volume.permute(0, 4, 1, 2, 3).reshape(b * s, 1, r, c), s


def _mr_tokens(volume, p, prefix, fe, train, prec, remat, drop):
    """A volume's slices through the feature extractor, dropout on the
    features; → (B, S, C) tokens."""
    images, s = _slices(volume)
    feats = fe_forward(images, p, prefix, fe["arch"], train, prec, remat)
    return _drop(drop, feats, fe.get("dropout") or 0.0).view(
        volume.shape[0], s, -1)


def forward(cfg: dict, p: dict, xs, train: bool = False, prec=FLOAT32,
            remat: bool = False, drop=None):
    """Preprocessed inputs (one tensor per modality, float32) → (B,
    classes) logits. ``drop``: a training step's :class:`Masks`, called
    in the order in which the program's forward pass calls its dropouts
    (the clinical token, the X-ray, the MRI features, then the FeaTs);
    None leaves dropout out, as eval does."""
    if cfg["name"] not in FAMILIES:
        return by_name("families", cfg["name"]).forward(
            cfg, p, xs, train, prec, remat, drop)
    agg = cfg["agg"]
    heads = int(agg["heads"])
    rates = (agg.get("emb_dropout") or 0.0, agg.get("mlp_dropout") or 0.0)
    if cfg["name"] == "MR1CnnTrf":
        tokens = _mr_tokens(xs[0], p, "_fe.", cfg["fe"], train, prec, remat,
                            drop)
        return feat(tokens, p, "_agg.", heads, prec, drop, rates)[0]
    fe = cfg["fe"]
    clin = _drop(drop, F.gelu(linear(xs[3], p["_fe3._fe.0.weight"],
                                     p["_fe3._fe.0.bias"], prec)),
                 fe["clin"].get("dropout") or 0.0)
    t_xr = _drop(drop, fe_forward(xs[0], p, "_fe0.", fe["xr"]["arch"],
                                  train, prec, remat),
                 fe["xr"].get("dropout") or 0.0)[:, None]
    tok1 = _mr_tokens(xs[1], p, "_fe1.", fe["mr"], train, prec, remat, drop)
    tok2 = _mr_tokens(xs[2], p, "_fe2.", fe["mr"], train, prec, remat, drop)
    _, s1 = feat(tok1, p, "_agg_1.", heads, prec, drop, rates)
    _, s2 = feat(tok2, p, "_agg_2.", heads, prec, drop, rates)
    tokens = torch.cat([t_xr, s1, s2, clin], dim=1)
    return feat(tokens, p, "_agg_final.", heads, prec, drop, rates)[0]
