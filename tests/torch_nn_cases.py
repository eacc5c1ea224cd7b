"""The ``nn`` sweep: one table of cases of ``nn.functional`` and of the
``nn`` layers that the CPU parity tests (``tests/test_torch_nn_*.py``:
the JAX package against the port) and ``chip_smoke.py`` phase 25 (e)
(the port on the card against the port on the CPU) both run.

A case is ``(id, fn, inputs, tol, grad, section)``, as in
``torch_op_cases.py``, ``section`` naming the part of ``nn`` it covers
(``SECTIONS``):

* ``fn(pkg, *tensors)`` calls the public API of a package
  (``paddle_tpu`` or ``paddle_tpu_torch``, which share it) and returns a
  tensor or a tuple of them; a layer case returns ``Layered(outputs,
  layer)``, and its parameters' gradients are compared too;
* a layer's parameters and buffers are seeded numpy values loaded with
  ``set_state_dict`` (``load``), so both packages compute with the same
  weights (their own initializers draw different values);
* ``inputs`` are numpy arrays made from seeds; ``tol`` names the
  tolerance (``TOLS``: fp32 forwards at 1e-5, gradients and
  transcendental chains at 1e-4); integer outputs compare exactly;
* ``grad``: the float inputs need a gradient, and the gradients of
  ``sum(out_k * w_k)`` (``w_k`` fixed random weights, ``grad_weights``)
  are compared, on the card and against the JAX package on the CPU
  (whose side ``tests/torch_nn_jax.py`` traces and compiles whole).

Dropout runs at ``p=0`` or in ``eval()``; random layers (``NCELoss``,
``gumbel_softmax``) are held by statistics in the test files instead.
This module imports numpy only.
"""
from __future__ import annotations

import zlib

import numpy as np

# rtol, atol
TOLS = {"f": (1e-5, 1e-5), "t": (1e-4, 1e-4)}

_rs = np.random.RandomState(0)


def f32(*shape, lo=-1.0, hi=1.0):
    return (_rs.rand(*shape) * (hi - lo) + lo).astype(np.float32)


def ints(*shape, lo=0, hi=5):
    return _rs.randint(lo, hi, shape).astype(np.int64)


class Layered(tuple):
    """A layer case's outputs, with the layer whose parameter gradients
    count too."""

    def __new__(cls, outs, layer):
        self = super().__new__(cls, outs if isinstance(outs, (tuple, list))
                               else (outs,))
        self.layer = layer
        return self


def seeded_state(layer):
    """Seeded numpy values for every entry of ``layer.state_dict()``
    (positive where a variance is)."""
    out = {}
    for name, t in layer.state_dict().items():
        rs = np.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
        shape = tuple(t.shape)
        if "variance" in name:
            out[name] = (rs.rand(*shape) + 0.5).astype(np.float32)
        else:
            out[name] = ((rs.rand(*shape) - 0.5) * 0.8).astype(np.float32)
    return out


# None, or a function ``hook(layer, state)`` that ``load`` calls in place
# of ``set_state_dict``: the traced JAX references set it to make the
# parameters inputs of the traced program
STATE_HOOK = [None]


def load(layer, train=False):
    if STATE_HOOK[0] is None:
        layer.set_state_dict(seeded_state(layer))
    else:
        STATE_HOOK[0](layer, seeded_state(layer))
    return layer.train() if train else layer.eval()


CASES = []
SECTIONS = ("activation", "common", "conv", "pooling", "norm", "loss",
            "extension", "attention")
_section = [SECTIONS[0]]


def section(name):
    assert name in SECTIONS
    _section[0] = name


def case(id, fn, inputs, tol="t", grad=True):
    CASES.append((id, fn, list(inputs), tol, grad, _section[0]))


def F(P):
    return P.nn.functional


# ---- activations ----------------------------------------------------------
_X = f32(3, 6, lo=-2.5, hi=2.5)
for name, kw in [("relu", {}), ("relu6", {}), ("sigmoid", {}), ("tanh", {}),
                 ("silu", {}), ("mish", {}), ("softsign", {}),
                 ("tanhshrink", {}), ("log_sigmoid", {}), ("gelu", {}),
                 ("gelu", {"approximate": True}),
                 ("leaky_relu", {"negative_slope": 0.2}),
                 ("elu", {"alpha": 0.7}), ("celu", {"alpha": 1.3}),
                 ("selu", {}), ("hardtanh", {"min": -0.5, "max": 0.7}),
                 ("hardsigmoid", {}), ("hardswish", {}), ("swish", {}),
                 ("hardshrink", {"threshold": 0.4}),
                 ("softshrink", {"threshold": 0.3}),
                 ("softplus", {"beta": 2.0, "threshold": 3.0}),
                 ("thresholded_relu", {"threshold": 0.5}),
                 ("softmax", {"axis": 0}), ("log_softmax", {"axis": -1}),
                 ("glu", {"axis": -1}), ("maxout", {"groups": 2, "axis": 1})]:
    case(f"F.{name}[{','.join(kw)}]" if name != "gelu" or not kw
         else "F.gelu[approximate]",
         lambda P, t, name=name, kw=kw: getattr(F(P), name)(t, **kw), [_X])
case("F.prelu", lambda P, t, w: F(P).prelu(t, w),
     [f32(2, 3, 4), f32(3, lo=0.1, hi=0.4)])
for cls, kw in [("ReLU", {}), ("GELU", {}), ("Softmax", {"axis": 1}),
                ("Maxout", {"groups": 3})]:
    case(f"nn.{cls}", lambda P, t, cls=cls, kw=kw:
         getattr(P.nn, cls)(**kw)(t), [_X])
case("nn.PReLU", lambda P, t: _layer(P, P.nn.PReLU(3), t), [f32(2, 3, 4)])


def _layer(P, layer, *xs, train=False):
    load(layer, train)
    return Layered(layer(*xs), layer)


# ---- common ---------------------------------------------------------------
section("common")
case("F.linear", lambda P, x, w, b: F(P).linear(x, w, b),
     [f32(2, 3, 4), f32(4, 5), f32(5)])
case("nn.Linear", lambda P, x: _layer(P, P.nn.Linear(4, 5), x),
     [f32(2, 3, 4)])
case("nn.Linear[no_bias]", lambda P, x: _layer(
    P, P.nn.Linear(4, 5, bias_attr=False), x), [f32(6, 4)])
case("F.embedding", lambda P, i, w: F(P).embedding(i, w, padding_idx=2),
     [ints(3, 4, hi=6), f32(6, 3)])
case("nn.Embedding", lambda P, i: _layer(P, P.nn.Embedding(7, 4), i),
     [ints(2, 5, hi=7)])
case("F.dropout[eval]", lambda P, x: F(P).dropout(
    x, 0.3, training=False, mode="downscale_in_infer"), [_X])
case("nn.Dropout[eval]", lambda P, x: P.nn.Dropout(0.5).eval()(x), [_X])
case("F.one_hot", lambda P, i: F(P).one_hot(i, 6), [ints(4, hi=6)],
     grad=False)
_IMG = f32(2, 3, 5, 6)
for mode in ("constant", "reflect", "replicate", "circular"):
    case(f"F.pad[{mode}]", lambda P, x, mode=mode: F(P).pad(
        x, [1, 2, 2, 1], mode=mode, value=0.5), [_IMG])
case("F.pad[full]", lambda P, x: F(P).pad(x, [1, 0, 0, 2, 0, 0, 1, 1]),
     [_IMG])
case("F.pad[NHWC]", lambda P, x: F(P).pad(
    x, [1, 2, 0, 1], mode="reflect", data_format="NHWC"),
    [f32(2, 5, 6, 3)])
case("nn.ZeroPad2D", lambda P, x: P.nn.ZeroPad2D([1, 1, 0, 2])(x), [_IMG])
case("F.pixel_shuffle", lambda P, x: F(P).pixel_shuffle(x, 2),
     [f32(2, 8, 3, 3)])
case("nn.PixelUnshuffle", lambda P, x: P.nn.PixelUnshuffle(2)(x),
     [f32(2, 2, 4, 6)])
for mode, size in [("nearest", (7, 9)), ("nearest", (3, 2)),
                   ("bilinear", (8, 11)), ("bilinear", (3, 4)),
                   ("bicubic", (7, 8))]:
    case(f"F.interpolate[{mode}{size}]", lambda P, x, mode=mode, size=size:
         F(P).interpolate(x, size=list(size), mode=mode), [_IMG],
         grad=mode != "nearest")
case("F.interpolate[linear]", lambda P, x: F(P).interpolate(
    x, scale_factor=2, mode="linear"), [f32(2, 3, 5)])
case("F.interpolate[trilinear]", lambda P, x: F(P).interpolate(
    x, size=[3, 5, 2], mode="trilinear"), [f32(1, 2, 4, 3, 4)])
case("nn.UpsamplingBilinear2D", lambda P, x: P.nn.UpsamplingBilinear2D(
    scale_factor=2)(x), [_IMG])
case("F.unfold", lambda P, x: F(P).unfold(x, 2, strides=1, paddings=1),
     [_IMG])
case("nn.Unfold[pad4]", lambda P, x: P.nn.Unfold([2, 3], 2, [1, 0, 0, 2])(x),
     [_IMG])
case("F.label_smooth", lambda P, x: F(P).label_smooth(x, epsilon=0.2),
     [f32(3, 5, lo=0, hi=1)])
case("F.label_smooth[prior]", lambda P, x, p: F(P).label_smooth(
    x, prior_dist=p, epsilon=0.1), [f32(3, 5, lo=0, hi=1),
                                    f32(1, 5, lo=0, hi=0.4)])
case("F.sequence_mask", lambda P, x: F(P).sequence_mask(x, maxlen=6),
     [ints(4, lo=1, hi=6)], grad=False)
case("F.cosine_similarity", lambda P, a, b: F(P).cosine_similarity(a, b),
     [f32(3, 4, 2), f32(3, 4, 2)])
case("nn.CosineSimilarity", lambda P, a, b: P.nn.CosineSimilarity(
    axis=-1)(a, b), [f32(3, 4), f32(3, 4)])
case("nn.Flatten", lambda P, x: P.nn.Flatten(1, 2)(x), [f32(2, 3, 4, 2)])
case("nn.Identity", lambda P, x: P.nn.Identity()(x), [_X])
case("nn.Bilinear", lambda P, a, b: _layer(P, P.nn.Bilinear(3, 4, 5), a, b),
     [f32(2, 3), f32(2, 4)])

# ---- conv -----------------------------------------------------------------
section("conv")
for nd, shape in [(1, (2, 4, 9)), (2, (2, 4, 7, 6)), (3, (1, 4, 5, 6, 5))]:
    x = f32(*shape)
    for kw in [dict(padding=1), dict(padding="SAME", stride=2),
               dict(padding="VALID", dilation=2), dict(groups=2, padding=2),
               dict(padding=[1, 0] * nd, stride=2)][:5 if nd == 2 else 2]:
        key = ",".join(f"{k}={v}" for k, v in kw.items())
        case(f"F.conv{nd}d[{key}]", lambda P, x, w, b, nd=nd, kw=kw:
             getattr(F(P), f"conv{nd}d")(x, w, b, **kw),
             [x, f32(6, 4 // kw.get("groups", 1), *([3] * nd)), f32(6)])
    for kw in [dict(stride=2, padding=1), dict(stride=2, output_padding=1),
               dict(padding=[0, 1] * nd, stride=3),
               dict(stride=2, dilation=2, padding=1)][:4 if nd < 3 else 1]:
        key = ",".join(f"{k}={v}" for k, v in kw.items())
        case(f"F.conv{nd}d_transpose[{key}]", lambda P, x, w, b, nd=nd, kw=kw:
             getattr(F(P), f"conv{nd}d_transpose")(x, w, b, **kw),
             [x, f32(4, 6 // kw.get("groups", 1), *([3] * nd)), f32(6)])
case("F.conv2d[NHWC]", lambda P, x, w: F(P).conv2d(
    x, w, padding=1, data_format="NHWC"), [f32(2, 5, 6, 3), f32(4, 3, 3, 3)])
case("F.conv2d_transpose[output_size]", lambda P, x, w: F(P).conv2d_transpose(
    x, w, stride=2, padding=1, output_size=[12, 10]),
    [f32(1, 3, 6, 5), f32(3, 2, 3, 3)])
case("nn.Conv1D", lambda P, x: _layer(P, P.nn.Conv1D(4, 6, 3, padding=1), x),
     [f32(2, 4, 8)])
case("nn.Conv2D", lambda P, x: _layer(
    P, P.nn.Conv2D(4, 6, 3, stride=2, padding=1, groups=2), x),
    [f32(2, 4, 7, 6)])
case("nn.Conv2DTranspose", lambda P, x: _layer(
    P, P.nn.Conv2DTranspose(4, 2, 4, stride=2, padding=1), x),
    [f32(1, 4, 5, 6)])
case("nn.Conv3DTranspose", lambda P, x: _layer(
    P, P.nn.Conv3DTranspose(4, 2, 2, stride=2), x), [f32(1, 4, 2, 3, 2)])

# ---- pooling --------------------------------------------------------------
section("pooling")
_DIST = (np.random.RandomState(5).permutation(2 * 3 * 7 * 6)
         .reshape(2, 3, 7, 6).astype(np.float32) / 100.0)
for kind in ("max", "avg"):
    for kw in [dict(kernel_size=2), dict(kernel_size=3, stride=2, padding=1),
               dict(kernel_size=3, stride=2, ceil_mode=True),
               dict(kernel_size=[2, 3], stride=[2, 1], padding="SAME"),
               dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)]:
        key = ",".join(f"{k}={v}" for k, v in kw.items())
        case(f"F.{kind}_pool2d[{key}]", lambda P, x, kind=kind, kw=kw:
             getattr(F(P), f"{kind}_pool2d")(x, **kw), [_DIST])
case("F.avg_pool2d[inclusive]", lambda P, x: F(P).avg_pool2d(
    x, 3, 2, 1, exclusive=False), [_DIST])
case("F.avg_pool3d", lambda P, x: F(P).avg_pool3d(x, 2, 1, 1),
     [f32(1, 2, 4, 3, 4)])
case("F.max_pool3d", lambda P, x: F(P).max_pool3d(x, 2, ceil_mode=True),
     [_DIST[:1, :, :, :, None].repeat(3, axis=-1)])
for kind in ("avg", "max"):
    for size in (2, (3, 4)):
        case(f"F.adaptive_{kind}_pool2d[{size}]", lambda P, x, kind=kind,
             size=size: getattr(F(P), f"adaptive_{kind}_pool2d")(x, size),
             [_DIST])
    case(f"F.adaptive_{kind}_pool1d", lambda P, x, kind=kind: getattr(
        F(P), f"adaptive_{kind}_pool1d")(x, 4), [_DIST[:, :, :, 0]])
    case(f"F.adaptive_{kind}_pool3d", lambda P, x, kind=kind: getattr(
        F(P), f"adaptive_{kind}_pool3d")(x, (2, 3, 2)),
        [_DIST[:1, :, :, :, None].repeat(3, axis=-1)])
case("nn.MaxPool2D", lambda P, x: P.nn.MaxPool2D(3, 2, 1, ceil_mode=True)(x),
     [_DIST])
case("nn.AvgPool1D", lambda P, x: P.nn.AvgPool1D(2)(x), [_DIST[:, :, :, 0]])
case("F.pool2d[global]", lambda P, x: F(P).pool2d(
    x, global_pooling=True, pool_type="avg"), [_DIST])

# ---- norm -----------------------------------------------------------------
section("norm")
case("F.batch_norm[train]", lambda P, x, m, v, w, b: F(P).batch_norm(
    x, m, v, w, b, training=True), [_IMG, f32(3), f32(3, lo=0.5, hi=1.5),
                                    f32(3), f32(3)])
case("F.batch_norm[infer]", lambda P, x, m, v: F(P).batch_norm(
    x, m, v, epsilon=1e-3), [_IMG, f32(3), f32(3, lo=0.5, hi=1.5)])
case("F.layer_norm", lambda P, x, w, b: F(P).layer_norm(x, [5, 6], w, b),
     [_IMG, f32(5, 6), f32(5, 6)])
case("F.instance_norm", lambda P, x, w, b: F(P).instance_norm(
    x, weight=w, bias=b), [_IMG, f32(3), f32(3)])
case("F.group_norm", lambda P, x, w, b: F(P).group_norm(x, 2, 1e-5, w, b),
     [f32(2, 4, 3, 3), f32(4), f32(4)])
case("F.normalize", lambda P, x: F(P).normalize(x, axis=-1), [_IMG])
case("F.normalize[p1]", lambda P, x: F(P).normalize(x, p=1, axis=1), [_IMG])
case("F.local_response_norm", lambda P, x: F(P).local_response_norm(
    x, 3, alpha=0.1), [f32(2, 5, 3, 3)])
for cls, args, x, train in [
        ("BatchNorm1D", (3,), f32(4, 3), True),
        ("BatchNorm2D", (3,), _IMG, True),
        ("BatchNorm2D", (3,), _IMG, False),
        ("LayerNorm", ([6],), _IMG, False),
        ("GroupNorm", (2, 4), f32(2, 4, 3, 3), False),
        ("InstanceNorm2D", (3,), _IMG, False),
        ("LocalResponseNorm", (3,), f32(2, 5, 3, 3), False)]:
    case(f"nn.{cls}[{'train' if train else 'eval'}]",
         lambda P, x, cls=cls, args=args, train=train: _bn_case(
             P, getattr(P.nn, cls)(*args), x, train), [x])
case("nn.SpectralNorm", lambda P, w: P.nn.SpectralNorm(
    [4, 3, 2], power_iters=2)(w), [f32(4, 3, 2)])


def _bn_case(P, layer, x, train):
    """A norm layer's output, and for a batch norm in training also its
    advanced running statistics."""
    load(layer, train)
    out = layer(x)
    stats = [b for n, b in layer.state_dict().items() if n.startswith("_")]
    return Layered([out, *(s * 1.0 for s in stats)], layer)


# ---- losses ---------------------------------------------------------------
section("loss")
_LOGITS = f32(6, 5, lo=-2, hi=2)
_LAB = ints(6, hi=5)
_LAB[2] = -100
for kw in [{}, dict(reduction="sum"), dict(reduction="none"),
           dict(label_smoothing=0.1), dict(use_softmax=False)]:
    key = ",".join(f"{k}={v}" for k, v in kw.items())
    lg = _LOGITS if "use_softmax" not in kw else f32(6, 5, lo=0.05, hi=1)
    case(f"F.cross_entropy[{key}]", lambda P, x, y, kw=kw:
         F(P).cross_entropy(x, y, **kw), [lg, _LAB])
case("F.cross_entropy[weight]", lambda P, x, y, w: F(P).cross_entropy(
    x, y, weight=w), [_LOGITS, _LAB, f32(5, lo=0.2, hi=1)])
case("F.cross_entropy[soft]", lambda P, x, y: F(P).cross_entropy(
    x, y, soft_label=True), [_LOGITS, f32(6, 5, lo=0, hi=0.4)])
case("F.cross_entropy[axis1]", lambda P, x, y: F(P).cross_entropy(
    x, y, axis=1), [f32(2, 5, 3), ints(2, 1, 3, hi=5)])
case("F.cross_entropy[label_dim]", lambda P, x, y: F(P).cross_entropy(
    x, y), [_LOGITS, ints(6, 1, hi=5)])
case("F.softmax_with_cross_entropy", lambda P, x, y:
     F(P).softmax_with_cross_entropy(x, y, return_softmax=True),
     [_LOGITS, ints(6, 1, hi=5)])
_P01 = f32(4, 3, lo=0.05, hi=0.95)
_T01 = (f32(4, 3) > 0).astype(np.float32)
case("F.binary_cross_entropy", lambda P, p, t, w: F(P).binary_cross_entropy(
    p, t, weight=w), [_P01, _T01, f32(4, 3, lo=0.1, hi=1)])
case("F.binary_cross_entropy_with_logits", lambda P, x, t, pw:
     F(P).binary_cross_entropy_with_logits(x, t, pos_weight=pw,
                                           reduction="sum"),
     [f32(4, 3, lo=-3, hi=3), _T01, f32(3, lo=0.5, hi=2)])
case("F.sigmoid_focal_loss", lambda P, x, t: F(P).sigmoid_focal_loss(x, t),
     [f32(4, 3, lo=-3, hi=3), _T01])
for name in ("mse_loss", "l1_loss", "square_error_cost"):
    case(f"F.{name}", lambda P, a, b, name=name: getattr(F(P), name)(a, b),
         [f32(4, 3), f32(4, 3)])
case("F.smooth_l1_loss", lambda P, a, b: F(P).smooth_l1_loss(
    a, b, delta=0.5), [f32(4, 3, lo=-2, hi=2), f32(4, 3)])
case("F.nll_loss", lambda P, x, y, w: F(P).nll_loss(x, y, weight=w),
     [np.log(f32(6, 5, lo=0.05, hi=1)), _LAB, f32(5, lo=0.2, hi=1)])
case("F.nll_loss[2d]", lambda P, x, y: F(P).nll_loss(x, y, reduction="sum"),
     [np.log(f32(2, 5, 3, lo=0.05, hi=1)), ints(2, 3, hi=5)])
case("F.kl_div", lambda P, x, t: F(P).kl_div(x, t, reduction="batchmean"),
     [np.log(f32(4, 3, lo=0.1, hi=1)), f32(4, 3, lo=0.05, hi=1)])
case("F.margin_ranking_loss", lambda P, a, b, y: F(P).margin_ranking_loss(
    a, b, y, margin=0.1), [f32(5), f32(5), np.sign(f32(5)) + 0.0])
case("F.hinge_embedding_loss", lambda P, x, y: F(P).hinge_embedding_loss(
    x, y), [f32(5, lo=0, hi=2), np.where(f32(5) > 0, 1.0, -1.0)
            .astype(np.float32)])
case("F.cosine_embedding_loss", lambda P, a, b, y: F(P).cosine_embedding_loss(
    a, b, y, margin=0.1), [f32(4, 3), f32(4, 3), np.array([1, -1, 1, -1])])
case("F.triplet_margin_loss", lambda P, a, p, n: F(P).triplet_margin_loss(
    a, p, n, swap=True), [f32(4, 3), f32(4, 3), f32(4, 3)])
case("F.log_loss", lambda P, p, t: F(P).log_loss(p, t), [_P01, _T01])
case("F.ctc_loss", lambda P, x, y, il, ll: F(P).ctc_loss(x, y, il, ll),
     [f32(8, 2, 5, lo=-2, hi=2), ints(2, 3, lo=1, hi=5),
      np.array([8, 6]), np.array([3, 2])])
case("F.fused_linear_cross_entropy", lambda P, h, w, y:
     F(P).fused_linear_cross_entropy(h, w, y, chunk_size=2),
     [f32(2, 4, 6), f32(6, 7), ints(2, 4, hi=7)])
for cls, args, xs in [
        ("CrossEntropyLoss", {}, [_LOGITS, _LAB]),
        ("L1Loss", {"reduction": "sum"}, [f32(4, 3), f32(4, 3)]),
        ("NLLLoss", {}, [np.log(f32(6, 5, lo=0.05, hi=1)), _LAB]),
        ("BCEWithLogitsLoss", {}, [f32(4, 3), _T01]),
        ("PairwiseDistance", {}, [f32(4, 3), f32(4, 3)])]:
    case(f"nn.{cls}", lambda P, *xs, cls=cls, args=args:
         getattr(P.nn, cls)(**args)(*xs), xs)
case("nn.HSigmoidLoss", lambda P, x, y: _layer(
    P, P.nn.HSigmoidLoss(4, 6), x, y), [f32(5, 4), ints(5, 1, hi=6)])
case("F.hsigmoid_loss", lambda P, x, y, w, b: F(P).hsigmoid_loss(
    x, y, 6, w, b), [f32(5, 4), ints(5, 1, hi=6), f32(5, 4), f32(5)])

# ---- extension ------------------------------------------------------------
section("extension")
_GRID = f32(2, 3, 4, 2, lo=-1.3, hi=1.3)
for mode, pad, ac in [("bilinear", "zeros", True),
                     ("bilinear", "border", False),
                     ("bilinear", "reflection", True),
                     ("bilinear", "reflection", False),
                     ("nearest", "zeros", False)]:
    case(f"F.grid_sample[{mode},{pad},{ac}]",
         lambda P, x, g, mode=mode, pad=pad, ac=ac: F(P).grid_sample(
             x, g, mode=mode, padding_mode=pad, align_corners=ac),
         [f32(2, 2, 4, 5), _GRID], grad=mode == "bilinear")
case("F.affine_grid", lambda P, t: F(P).affine_grid(t, [2, 1, 3, 4]),
     [f32(2, 2, 3)])
case("F.affine_grid[half_pixel]", lambda P, t: F(P).affine_grid(
    t, [2, 1, 3, 4], align_corners=False), [f32(2, 2, 3)])
case("F.diag_embed", lambda P, x: F(P).diag_embed(x, offset=1), [f32(2, 3)])
case("F.diag_embed[dims]", lambda P, x: F(P).diag_embed(
    x, offset=-1, dim1=0, dim2=2), [f32(2, 3)])
case("F.gather_tree", lambda P, i, p: F(P).gather_tree(i, p),
     [ints(4, 2, 3, hi=9), ints(4, 2, 3, hi=3)], grad=False)
case("F.bilinear", lambda P, a, b, w, c: F(P).bilinear(a, b, w, c),
     [f32(3, 2), f32(3, 4), f32(5, 2, 4), f32(1, 5)])
case("F.dice_loss", lambda P, x, y: F(P).dice_loss(x, y),
     [f32(3, 4, 5, lo=0, hi=1), ints(3, 4, 1, hi=5)])
case("F.npair_loss", lambda P, a, p, y: F(P).npair_loss(a, p, y),
     [f32(4, 6), f32(4, 6), np.array([0, 1, 0, 2])])
case("F.linear_chain_crf", lambda P, e, t, y, n: F(P).linear_chain_crf(
    e, t, y, n), [f32(2, 4, 3), f32(5, 3), ints(2, 4, hi=3),
                  np.array([4, 2])])
case("F.viterbi_decode", lambda P, e, t, n: F(P).viterbi_decode(e, t, n),
     [f32(2, 4, 5), f32(5, 5), np.array([4, 2])], grad=False)
case("F.add_position_encoding", lambda P, x: F(P).add_position_encoding(
    x, alpha=0.5, beta=2.0), [f32(2, 4, 7)])
case("F.pad_constant_like", lambda P, x, y: F(P).pad_constant_like(
    x, y, 1.5), [f32(3, 5), f32(2, 3)])
case("F.fsp_matrix", lambda P, x, y: F(P).fsp_matrix(x, y),
     [f32(2, 3, 4, 4), f32(2, 2, 4, 4)])
case("F.im2sequence", lambda P, x: F(P).im2sequence(
    x, filter_size=[2, 3], stride=[1, 2], padding=[1, 0, 0, 1]),
    [f32(2, 2, 4, 5)])
case("F.hash", lambda P, x: F(P).hash(x, 100, num_hash=3),
     [ints(5, hi=1000)], grad=False)

# ---- attention ------------------------------------------------------------
section("attention")
_Q, _K, _V = f32(2, 5, 2, 4), f32(2, 5, 2, 4), f32(2, 5, 2, 4)
case("F.scaled_dot_product_attention", lambda P, q, k, v:
     F(P).scaled_dot_product_attention(q, k, v), [_Q, _K, _V])
case("F.scaled_dot_product_attention[causal]", lambda P, q, k, v:
     F(P).scaled_dot_product_attention(q, k, v, is_causal=True),
     [_Q, _K, _V])
case("F.scaled_dot_product_attention[mask]", lambda P, q, k, v, m:
     F(P).scaled_dot_product_attention(q, k, v, attn_mask=m),
     [_Q, _K, _V, f32(2, 1, 5, 5, lo=-3, hi=0)])
case("nn.MultiHeadAttention", lambda P, q, k: _layer(
    P, P.nn.MultiHeadAttention(8, 2, kdim=6, vdim=6), q, k, k),
    [f32(2, 4, 8), f32(2, 5, 6)])
case("nn.TransformerEncoderLayer", lambda P, x: _layer(
    P, P.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                    normalize_before=True), x),
    [f32(2, 5, 8)])
case("nn.TransformerDecoderLayer", lambda P, x, m: _layer(
    P, P.nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0,
                                    activation="gelu"), x, m),
    [f32(2, 3, 8), f32(2, 5, 8)])


def flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in flat(x)]
    return [out]


def grad_weights(shape, k):
    """The fixed weights of output ``k`` in the gradient's loss."""
    return np.asarray(np.random.RandomState(100 + k).rand(*shape),
                      np.float32)


def run_case(pkg, case, grad):
    """``(output values, gradients or None)`` of ``case`` through ``pkg``
    on its current place: the float inputs' gradients, then a layer
    case's parameters' (in ``state_dict`` order)."""
    _, fn, inputs, _, _, _ = case
    ts = [pkg.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
          for a in inputs]
    res = fn(pkg, *ts)
    outs = flat(res)
    vals = [o.numpy() for o in outs]
    if not grad:
        return vals, None
    loss = None
    for k, o in enumerate(outs):
        if not o.stop_gradient and o.numpy().dtype.kind == "f":
            term = pkg.sum(o * pkg.to_tensor(grad_weights(o.shape, k)))
            loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    grads = [t.grad.numpy() if t.grad is not None else None for t in ts]
    layer = getattr(res, "layer", None)
    if layer is not None:
        grads += [p.grad.numpy() if p.grad is not None else None
                  for p in layer.parameters()]
    return vals, grads


def compare(got, want, tol, what):
    """Raise ``AssertionError`` unless ``got`` matches ``want`` (integers
    exactly, floats at ``TOLS[tol]``); returns the largest absolute
    difference."""
    rtol, atol = TOLS[tol]
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind in "biu" or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.astype(np.float64), err_msg=what)
        return 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def compare_grads(got, want, tol, what):
    """``compare`` over gradients; a missing gradient equals zeros."""
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        if g is None or w is None:
            assert not np.any(np.asarray(w if g is None else g)), (what, k)
            continue
        err = max(err, compare(g, w, tol, f"{what} grad {k}"))
    return err


def parity(port, ref, case, grad):
    """Hold ``case`` through ``port`` to ``ref`` (two packages on the
    CPU, or the port on two places; or a function of the case giving the
    reference outputs and gradients): the outputs, and with ``grad`` the
    gradients too."""
    got, gg = run_case(port, case, grad)
    want, wg = (ref(case) if callable(ref) else run_case(ref, case, grad))
    assert len(got) == len(want), case[0]
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        err = max(err, compare(g, w, case[3], f"{case[0]} output {k}"))
    if grad:
        err = max(err, compare_grads(gg, wg, case[3], case[0]))
    return err
