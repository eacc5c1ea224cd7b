"""Extension functionals — counterpart of
``paddle_tpu/nn/functional/extension.py``: ``grid_sample``,
``affine_grid``, ``diag_embed``, ``gather_tree`` (the beam-search
backtrace), ``bilinear``, ``dice_loss``, ``npair_loss``,
``linear_chain_crf``, ``viterbi_decode``, ``add_position_encoding``,
``pad_constant_like``, ``fsp_matrix``, ``im2sequence`` and ``hash``.

Each takes torch tensors or handles (``_io.api``).  The JAX package's
``lax.scan`` / ``fori_loop`` recurrences (the CRF's forward algorithm,
Viterbi, ``gather_tree``) are loops over time steps here, each step one
batched torch op; ``grid_sample`` gathers the four neighbours as the JAX
package does (its reflection and zero padding included).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from ... import amp
from ._io import api


# ---- grid_sample ---------------------------------------------------------
@api
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x ``[N, C, H, W]``, grid ``[N, Hg, Wg, 2]`` in [-1, 1] (x, y)."""
    x, grid = amp.cast_inputs("grid_sample", x, grid)
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]

    def unnorm(coord, size):
        if align_corners:
            return (coord + 1) * (size - 1) / 2
        return ((coord + 1) * size - 1) / 2

    fx, fy = unnorm(gx, w), unnorm(gy, h)
    if padding_mode == "reflection":
        def reflect(coord, size):
            if align_corners:
                span = 2 * (size - 1)
                if span == 0:
                    return torch.zeros_like(coord)
                m = torch.remainder(coord.abs(), span)
                return torch.where(m > size - 1, span - m, m)
            span = 2 * size
            r = torch.remainder((coord + 0.5).abs(), span)
            r = torch.where(r > size, span - r, r) - 0.5
            return torch.clamp(r, 0, size - 1)

        fx, fy = reflect(fx, w), reflect(fy, h)
    batch = torch.arange(n, device=x.device).reshape(n, 1, 1)

    def sample(ix, iy):
        vals = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            vals = torch.where(valid[..., None], vals,
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device))
        return vals

    if mode == "nearest":
        out = sample(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
        out = (sample(x0, y0) * ((1 - wx) * (1 - wy))
               + sample(x0 + 1, y0) * (wx * (1 - wy))
               + sample(x0, y0 + 1) * ((1 - wx) * wy)
               + sample(x0 + 1, y0 + 1) * (wx * wy))
    return out.permute(0, 3, 1, 2)


# ---- diag_embed ----------------------------------------------------------
@api
def diag_embed(input, offset=0, dim1=-2, dim2=-1):
    out = torch.diag_embed(input, offset=offset, dim1=-2, dim2=-1)
    nd = out.dim()
    d1 = dim1 if dim1 >= 0 else nd + dim1
    d2 = dim2 if dim2 >= 0 else nd + dim2
    if (d1, d2) != (nd - 2, nd - 1):
        out = torch.movedim(out, (nd - 2, nd - 1), (d1, d2))
    return out


# ---- gather_tree (beam search backtrace) ---------------------------------
@api
def gather_tree(ids, parents):
    """ids / parents ``[T, B, beam]`` -> the whole predicted sequences:
    from the last step backwards, each beam's token and its parent's."""
    T = ids.shape[0]
    out = torch.empty_like(ids)
    idx = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).contiguous()
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(ids[t], -1, idx)
        idx = torch.gather(parents[t], -1, idx)
    return out


# ---- bilinear tensor product ---------------------------------------------
@api
def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias)``, weight
    ``[out, d1, d2]``."""
    args = (x1, x2, weight) if bias is None else (x1, x2, weight, bias)
    x1, x2, weight, *b = amp.promote(*amp.cast_inputs("bilinear", *args))
    out = torch.einsum("bd,ode,be->bo", x1, weight, x2)
    return out + b[0] if b else out


bilinear_tensor_product = bilinear


# ---- losses --------------------------------------------------------------
@api
def dice_loss(input, label, epsilon=1e-5, name=None):
    input, = amp.cast_inputs("dice_loss", input)
    yf = F.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    red = tuple(range(1, input.dim()))
    inter = (input * yf).sum(dim=red)
    union = input.sum(dim=red) + yf.sum(dim=red)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


@api
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    a, p = amp.cast_inputs("npair_loss", anchor, positive)
    lab = labels.reshape(-1)
    tgt = (lab[:, None] == lab[None, :]).to(a.dtype)
    tgt = tgt / tgt.sum(-1, keepdim=True)
    ce = (-tgt * torch.log_softmax(a @ p.t(), dim=-1)).sum(-1).mean()
    reg = l2_reg * ((a * a).sum(-1).mean() + (p * p).sum(-1).mean()) * 0.25
    return ce + reg


# ---- affine_grid (pairs with grid_sample) --------------------------------
@api
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta ``[N, 2, 3]`` -> the sampling grid ``[N, H, W, 2]``; 4-D
    output shapes only."""
    if hasattr(out_shape, "tolist"):
        out_shape = [int(v) for v in out_shape.tolist()]
    if len(out_shape) != 4:
        raise NotImplementedError(
            "affine_grid: only 4-D (N, C, H, W) output shapes are "
            "supported; 3-D volumetric grids (N, C, D, H, W) are not "
            "implemented")
    _, _, h, w = out_shape
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev)
        xs = torch.linspace(-1, 1, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("nij,hwj->nhwi", theta, base.to(theta.dtype))


# ---- linear-chain CRF ----------------------------------------------------
@api
def linear_chain_crf(emission, transition, label, length, name=None):
    """Negative log-likelihood ``[B, 1]`` of each tag sequence under the
    CRF: ``transition [N + 2, N]`` holds the start weights (row 0), the
    stop weights (row 1) and ``transition[from][to]`` (rows 2..)."""
    emission, transition = amp.cast_inputs("linear_chain_crf", emission,
                                           transition)
    b, t, n = emission.shape
    start_w, stop_w, trans = transition[0], transition[1], transition[2:]
    lab, ln = label.long(), length.long()
    steps = torch.arange(t, device=emission.device)
    zero = torch.zeros((), dtype=emission.dtype, device=emission.device)
    emit = torch.gather(emission, 2, lab[..., None])[..., 0]
    emit = torch.where(steps[None, :] < ln[:, None], emit, zero).sum(1)
    pair = trans[lab[:, :-1], lab[:, 1:]]
    pair = torch.where(steps[None, 1:] < ln[:, None], pair, zero).sum(1)
    last = torch.clamp(ln - 1, min=0)
    gold = emit + pair + start_w[lab[:, 0]] \
        + stop_w[torch.gather(lab, 1, last[:, None])[:, 0]]
    alpha = start_w[None, :] + emission[:, 0]
    for i in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, i]
        alpha = torch.where((i < ln)[:, None], new, alpha)
    logz = torch.logsumexp(alpha + stop_w[None, :], dim=-1)
    return (logz - gold)[:, None]


@api
def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """The best tag path and its score (``paddle.text``'s contract: a
    SQUARE ``[N, N]`` transition; with ``include_bos_eos_tag`` tag
    ``N - 2`` is the start and ``N - 1`` the stop).  Positions past a
    length keep the last valid tag."""
    em, trans = potentials.detach(), transition_params.detach()
    b, t, n = em.shape
    ln = lengths.long()
    if include_bos_eos_tag:
        start_w, stop_w = trans[n - 2], trans[:, n - 1]
    else:
        start_w = torch.zeros(n, dtype=em.dtype, device=em.device)
        stop_w = start_w
    ident = torch.arange(n, device=em.device).expand(b, n)
    score = start_w[None, :] + em[:, 0]
    backs = []
    for i in range(1, t):
        cand = score[:, :, None] + trans[None] + em[:, i][:, None, :]
        new, back = cand.max(dim=1)
        live = (i < ln)[:, None]
        score = torch.where(live, new, score)
        backs.append(torch.where(live, back, ident))
    score = score + stop_w[None, :]
    best_score, tag = score.max(dim=-1)
    path = [tag]
    for back in reversed(backs):
        tag = torch.gather(back, 1, tag[:, None])[:, 0]
        path.append(tag)
    return best_score, torch.stack(path[::-1], dim=1)


# ---- fluid long-tail functionals -----------------------------------------
@api
def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """``alpha * x + beta * PE`` with the sinusoidal encoding (sin over
    the first half of the features, cos over the second)."""
    b, t, d = input.shape
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=input.device)[:, None]
    div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=input.device) / half)
    ang = pos / div[None, :]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if enc.shape[-1] < d:
        enc = F.pad(enc, (0, d - enc.shape[-1]))
    return alpha * input + beta * enc[None].to(input.dtype)


@api
def pad_constant_like(x, y, pad_value=0.0, name=None):
    """``y`` padded at the end of each dim up to ``x``'s shape."""
    if any(int(a) < int(b) for a, b in zip(x.shape, y.shape)):
        raise ValueError(
            f"pad_constant_like requires x.shape >= y.shape elementwise, "
            f"got x {list(x.shape)} vs y {list(y.shape)}")
    cfg = []
    for a, b in zip(reversed(x.shape), reversed(y.shape)):
        cfg += [0, int(a) - int(b)]
    return F.pad(y, cfg, value=float(pad_value))


@api
def fsp_matrix(x, y):
    """``[B, C1, H, W] x [B, C2, H, W] -> [B, C1, C2]`` over ``H * W``."""
    b, c1, h, w = x.shape
    return torch.einsum("bcm,bdm->bcd", x.reshape(b, c1, h * w),
                        y.reshape(b, y.shape[1], h * w)) / (h * w)


@api
def im2sequence(input, filter_size=1, stride=1, padding=0, name=None,
                input_image_size=None, out_stride=1):
    """Sliding blocks as sequence rows ``[N * OH * OW, C * fh * fw]``;
    ``padding`` one int, two (per dim) or four (``[up, left, down,
    right]``)."""
    if input_image_size is not None:
        raise NotImplementedError(
            "im2sequence: per-image input_image_size/out_stride (real-"
            "size mode) is not implemented — pad to a uniform size "
            "upstream")
    fs = (filter_size,) * 2 if isinstance(filter_size, int) \
        else tuple(filter_size)
    st = (stride,) * 2 if isinstance(stride, int) else tuple(stride)
    if isinstance(padding, int):
        pd = (padding, padding, padding, padding)
    elif len(padding) == 2:
        pd = (padding[0], padding[0], padding[1], padding[1])
    elif len(padding) == 4:
        pd = (padding[0], padding[2], padding[1], padding[3])
    else:
        raise ValueError(f"im2sequence: bad padding {padding!r}")
    n, c = input.shape[:2]
    x = F.pad(input, (pd[2], pd[3], pd[0], pd[1]))
    oh = (x.shape[2] - fs[0]) // st[0] + 1
    ow = (x.shape[3] - fs[1]) // st[1] + 1
    cols = F.unfold(x, fs, stride=st)
    return cols.reshape(n, c * fs[0] * fs[1], oh * ow).transpose(1, 2) \
        .reshape(n * oh * ow, c * fs[0] * fs[1])


@api
def hash(input, hash_size, num_hash=1, name=None):
    """``num_hash`` multiplicative hashes of each id into ``[0,
    hash_size)`` (uint32 arithmetic, the JAX package's constants),
    stacked on a new last axis as int32."""
    ids = input.long() & 0xFFFFFFFF
    out = []
    for i in range(num_hash):
        salt = (i * 0x9E3779B9) & 0xFFFFFFFF
        mixed = (ids * 2654435761 + salt) & 0xFFFFFFFF
        out.append((mixed % int(hash_size)).to(torch.int32))
    return torch.stack(out, dim=-1)
