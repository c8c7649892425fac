"""SIFT detect-and-compute over a canvas-packed scale space (port of
vo_tpu/frontend/sift.py, canvas path).

As in vo_tpu, with OpenCV's defaults (3 layers per octave, contrast 0.04,
edge 10, sigma 1.6, 2x upsample): the octaves' Gaussian and DoG stacks are
packed onto one canvas; DoG extrema by 3x3x3 max/min pooling; per-octave
top-k candidates; up to 4 Newton steps of subpixel refinement with
re-localization inside the candidate's octave rectangle; Lowe's contrast
and edge gates; a 36-bin orientation histogram from dense tent weights,
with the best secondary peak >= 0.8 max emitted as a second keypoint; a
4x4x8 descriptor by trilinear tent binning, normalized, clipped at 0.2 and
renormalized to 512. Gradient samples are the nearest pixel of central
differences of the Gaussian layers.

Two kernels carry the gradient sampling: B4 (`rowconv_cuda`) computes the
gradient maps of the layer-flattened Gaussian canvas, and B3 (`crop_cuda`)
cuts each keypoint's window out of them, from which its samples are picked.
The per-octave path (vo_tpu's ``SiftConfig.canvas=False``) is not ported.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.linalg3 import solve3x3
from ..ops import crop_cuda, rowconv_cuda
from ..ops.canvas import interior_mask, pack_canvas
from ..ops.nms import blocked_topk_2d, topk_stable
from ..ops.scalespace import build_scale_space, n_octaves_for


class SiftConfig(NamedTuple):
    nfeatures: int = 3000  # output capacity
    n_layers: int = 3  # nOctaveLayers
    contrast_threshold: float = 0.04
    edge_threshold: float = 10.0
    sigma: float = 1.6
    upsample: bool = True  # OpenCV firstOctave = -1
    max_image_octaves: int = 8  # octaves that give candidates
    ori_grid: int = 13  # orientation samples per axis
    desc_grid: int = 16  # descriptor samples per axis


class SiftFeatures(NamedTuple):
    xs: torch.Tensor  # (K,) input-image coordinates
    ys: torch.Tensor  # (K,)
    sizes: torch.Tensor  # (K,) keypoint diameter (OpenCV size semantics)
    scores: torch.Tensor  # (K,) |DoG| response
    angles: torch.Tensor  # (K,) radians
    desc: torch.Tensor  # (K, 128) float32, L2-normalized * 512
    valid: torch.Tensor  # (K,) bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1)


def octave_budgets(config: SiftConfig, n_oct: int) -> list[int]:
    """Per-octave candidate budgets: the full nfeatures on the upsampled
    octave, then a 0.32 geometric decay (vo_tpu's measured keypoint
    distribution on KITTI), at least 16 each."""
    return [max(16, int(round(config.nfeatures * 0.32**o)))
            for o in range(n_oct)]


def sample_grid(half: float, n: int) -> np.ndarray:
    """jnp.linspace(-half, half, n, dtype=float32) as vo_tpu's jitted
    program computes it (bit for bit): XLA rewrites the endpoint blend
    start * (1 - i/d) + stop * (i/d) into start * (1 - i*r) + i * (stop*r)
    with r = f32(1/d), each step rounded to f32."""
    f = np.float32
    d = n - 1
    r = f(1.0) / f(d)
    i = np.arange(d, dtype=f)
    a, b = f(-half), f(half)
    out = a * (f(1.0) - i * r) + i * (b * r)
    return np.concatenate([out, [b]]).astype(f)


def _extrema_mask(dog: torch.Tensor, threshold: float) -> torch.Tensor:
    """(L+2, H, W) DoG stack -> (L, H, W) bool: layers 1..L equal to the
    max or min of their 3x3x3 neighbourhood (-inf beyond the spatial edge;
    plateau ties pass) with |value| above the prefilter threshold."""
    x = dog[None, None]
    pmax = F.max_pool3d(x, 3, stride=1, padding=(0, 1, 1))[0, 0]
    pmin = -F.max_pool3d(-x, 3, stride=1, padding=(0, 1, 1))[0, 0]
    c = dog[1:-1]
    return ((c == pmax) | (c == pmin)) & (c.abs() > threshold)


def _refine_once(dog: torch.Tensor, ls, ys, xs):
    """One Newton step on each candidate's 3x3x3 neighbourhood. Returns
    (off (N, 3) [dx, dy, ds] unclamped, contrast at the offset, tr, det)."""
    _, H, W = dog.shape
    d = torch.arange(-1, 2, device=dog.device)
    off = ((d[:, None, None] * H + d[None, :, None]) * W
           + d[None, None, :]).reshape(-1)
    base = (ls * H + ys) * W + xs
    nb = dog.reshape(-1)[base[:, None] + off].reshape(-1, 3, 3, 3)

    def g(dl, dy, dx):
        return nb[:, dl + 1, dy + 1, dx + 1]

    v = g(0, 0, 0)
    dx_ = 0.5 * (g(0, 0, 1) - g(0, 0, -1))
    dy_ = 0.5 * (g(0, 1, 0) - g(0, -1, 0))
    ds_ = 0.5 * (g(1, 0, 0) - g(-1, 0, 0))
    dxx = g(0, 0, 1) + g(0, 0, -1) - 2 * v
    dyy = g(0, 1, 0) + g(0, -1, 0) - 2 * v
    dss = g(1, 0, 0) + g(-1, 0, 0) - 2 * v
    dxy = 0.25 * (g(0, 1, 1) - g(0, 1, -1) - g(0, -1, 1) + g(0, -1, -1))
    dxs = 0.25 * (g(1, 0, 1) - g(1, 0, -1) - g(-1, 0, 1) + g(-1, 0, -1))
    dys = 0.25 * (g(1, 1, 0) - g(1, -1, 0) - g(-1, 1, 0) + g(-1, -1, 0))

    Hm = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                      torch.stack([dxy, dyy, dys], -1),
                      torch.stack([dxs, dys, dss], -1)], -2)
    grad = torch.stack([dx_, dy_, ds_], -1)
    # regularize singular Hessians; those points fail the offset gate
    Hm = Hm + 1e-6 * torch.eye(3, dtype=dog.dtype, device=dog.device)
    off = -solve3x3(Hm, grad, eps=1e-18)
    contr = v + 0.5 * (grad * off).sum(-1)
    return off, contr, dxx + dyy, dxx * dyy - dxy * dxy


_REFINE_STEPS = 4  # OpenCV SIFT_MAX_INTERP_STEPS = 5; 4 recovers ~all


def _refine(dog: torch.Tensor, ls, ys, xs, border: int, rect):
    """Newton steps with re-localization to the rounded neighbouring sample
    while any |offset| >= 0.5, clipped to the candidate's octave rectangle
    `rect` (x0, y0, x1, y1) less `border`; candidates still moving after
    the last step are rejected. Returns (ls, ys, xs, off clamped, contr,
    converged, tr, det)."""
    L_total = dog.shape[0]
    x0, y0, x1, y1 = rect
    for it in range(_REFINE_STEPS):
        off, contr, tr, det = _refine_once(dog, ls, ys, xs)
        if it == _REFINE_STEPS - 1:
            break
        move = (off.abs() >= 0.5).any(-1)
        # NaN offsets (garbage slots) move by 0, as XLA converts NaN to 0
        step = torch.round(off).nan_to_num(0.0).clamp(-(2**20), 2**20).long()
        xs = torch.where(move, torch.minimum(torch.maximum(
            xs + step[:, 0], x0 + border), x1 - 1 - border), xs)
        ys = torch.where(move, torch.minimum(torch.maximum(
            ys + step[:, 1], y0 + border), y1 - 1 - border), ys)
        ls = torch.where(move, (ls + step[:, 2]).clamp(1, L_total - 2), ls)
    converged = (off.abs() < 0.5).all(-1)
    off = off.clamp(-0.5, 0.5)
    contr = torch.where(converged, contr, torch.zeros_like(contr))
    return ls, ys, xs, off, contr, converged, tr, det


def _dense_hist(weights, pos, n_bins: int, circular: bool):
    """Tent-weight histogram: weights and positions (N, S) in bin units ->
    (N, n_bins), as a batched product instead of a scatter."""
    bins = torch.arange(n_bins, dtype=weights.dtype, device=weights.device)
    d = pos[..., None] - bins  # (N, S, B)
    if circular:
        d = d - n_bins * torch.round(d / n_bins)
    tent = torch.clamp(1.0 - d.abs(), min=0.0)
    return torch.bmm(weights[:, None, :], tent)[:, 0]


DIFF_TAPS = (-0.5, 0.0, 0.5)


def _grad_maps(g: torch.Tensor):
    """Central-difference gradients of a (L, H, W) Gaussian stack, taken
    over the layer-flattened (L*H, W) array by kernel B4: a layer's edge
    rows see the neighbouring layer's rows instead of reflected ones, as in
    vo_tpu (outside the detection border either way). Both passes come
    from one read of the stack. Returns the flat (L*H, W) maps gx, gy."""
    L, H, W = g.shape
    return rowconv_cuda.conv_rows_cols(g.reshape(L * H, W), DIFF_TAPS)


def _sample_grad_win(gx, gy, H: int, ls0, cy, cx, ys, xs, rpad: int, rect):
    """Nearest-pixel gradient samples at (N, P) positions (ys, xs) of
    layer ls0 from the flat (L*H, W) maps, clamped to each keypoint's
    octave rectangle. Kernel B3 cuts one (S, S) window, S = 2 rpad + 1,
    around each keypoint's rounded centre (cy, cx) out of both maps in one
    launch (zeros past the maps' edge, which no sample reaches), and each
    sample is picked from it by one gather over both: the same values as
    vo_tpu's padded crop and one-hot pick."""
    L = gx.shape[0] // H
    bx0, by0, bx1, by1 = rect
    yi = torch.minimum(torch.maximum(torch.round(ys).long(), by0[:, None]),
                       by1[:, None] - 1)
    xi = torch.minimum(torch.maximum(torch.round(xs).long(), bx0[:, None]),
                       bx1[:, None] - 1)
    cyi = torch.minimum(torch.maximum(torch.round(cy).long(), by0), by1 - 1)
    cxi = torch.minimum(torch.maximum(torch.round(cx).long(), bx0), bx1 - 1)
    S = 2 * rpad + 1
    oy = ls0.clamp(0, L - 1) * H + cyi
    win = crop_cuda.crop_windows_pair(gx, gy, cxi - rpad, oy - rpad, S)
    rely = (yi - cyi[:, None] + rpad).clamp(0, S - 1)
    relx = (xi - cxi[:, None] + rpad).clamp(0, S - 1)
    pick = rely * S + relx
    N = pick.shape[0]
    sgx, sgy = win.reshape(2, N, S * S).gather(2, pick.expand(2, -1, -1))
    return sgx, sgy


def _max_sigma(cfg: SiftConfig, n_dog_layers: int) -> float:
    """Upper bound on the refined octave-local sigma (refine clamps
    ls <= L-2 and |off_s| <= 0.5)."""
    fl_max = (n_dog_layers - 2) + 0.5
    return cfg.sigma * 2.0 ** (fl_max / cfg.n_layers)


# Sample-grid half-extents; the window radii derive from them, since a
# sample outside its window would be clamped to the window's edge.
_ORI_RADIUS_SIG = 4.5  # orientation grid half-extent, in keypoint sigmas
_DESC_D = 4  # descriptor spatial bins per axis (Lowe 4x4)
_DESC_HALF_BINS = _DESC_D / 2 + 0.45  # descriptor grid half-extent, bins
TWO_PI = 2 * math.pi


def _mesh(half: float, n: int, device):
    """Flattened meshgrid (indexing "xy") of the sample grid: (uu, vv)."""
    u = torch.from_numpy(sample_grid(half, n)).to(device)
    return u[None, :].expand(n, n).reshape(-1), u[:, None].expand(n, n).reshape(-1)


def _orientations(gx, gy, H, n_gauss, ls, ys, xs, sig, cfg: SiftConfig,
                  rect):
    """Dominant orientation per keypoint, the best secondary peak's and
    whether that peak reaches 0.8 of the dominant one (radians)."""
    uu, vv = _mesh(_ORI_RADIUS_SIG, cfg.ori_grid, gx.device)
    px = xs[:, None] + uu[None] * sig[:, None]
    py = ys[:, None] + vv[None] * sig[:, None]
    rpad = int(np.ceil(_ORI_RADIUS_SIG * _max_sigma(cfg, n_gauss - 1))) + 1
    sgx, sgy = _sample_grad_win(gx, gy, H, ls, ys, xs, py, px, rpad, rect)
    mag = torch.sqrt(sgx * sgx + sgy * sgy)
    ang = torch.atan2(sgy, sgx)  # (-pi, pi]
    r2 = (uu * uu + vv * vv)[None]
    w = torch.exp(-r2 / (2.0 * 1.5 * 1.5)) * mag
    w = torch.where(r2 <= _ORI_RADIUS_SIG**2, w, torch.zeros_like(w))

    pos = torch.remainder(ang / TWO_PI * 36.0, 36.0)
    hist = _dense_hist(w, pos, 36, circular=True)
    # circular smoothing [1, 4, 6, 4, 1] / 16 (OpenCV calcOrientationHist)
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float32,
                     device=hist.device) / 16.0
    idx = (torch.arange(36, device=hist.device)[None, :]
           + torch.arange(-2, 3, device=hist.device)[:, None]) % 36
    hist = torch.einsum("k,nkb->nb", k, hist[:, idx])

    def peak_angle(peak):
        hp = hist.gather(1, peak[:, None])[:, 0]
        hl = hist.gather(1, ((peak - 1) % 36)[:, None])[:, 0]
        hr = hist.gather(1, ((peak + 1) % 36)[:, None])[:, 0]
        denom = hl - 2.0 * hp + hr
        interp = torch.where(denom.abs() > 1e-9, 0.5 * (hl - hr) / denom,
                             torch.zeros_like(denom))
        bin_f = torch.remainder(peak.float() + interp.clamp(-0.5, 0.5), 36.0)
        return bin_f / 36.0 * 2.0 * math.pi, hp

    peak = torch.argmax(hist, dim=1)
    ang1, hmax = peak_angle(peak)
    # the best secondary local max (OpenCV emits a keypoint per peak >= 0.8
    # max; one secondary keeps the capacity fixed)
    is_local_max = ((hist >= torch.roll(hist, 1, dims=1))
                    & (hist >= torch.roll(hist, -1, dims=1)))
    cols = torch.arange(36, device=hist.device)[None, :]
    cand = torch.where(is_local_max & (cols != peak[:, None]), hist,
                       torch.full_like(hist, -math.inf))
    peak2 = torch.argmax(cand, dim=1)
    h2 = cand.gather(1, peak2[:, None])[:, 0]
    ang2, _ = peak_angle(peak2)
    return ang1, ang2, h2 >= 0.8 * hmax


def _descriptors(gx, gy, H, n_gauss, ls, ys, xs, sig, theta,
                 cfg: SiftConfig, rect):
    """(N, 128) Lowe descriptors by trilinear tent binning."""
    D = _DESC_D
    uu, vv = _mesh(_DESC_HALF_BINS, cfg.desc_grid, gx.device)
    hist_w = 3.0 * sig  # pixels per spatial bin (SIFT_DESCR_SCL_FCTR)
    ct, st = torch.cos(theta), torch.sin(theta)
    dx = (ct[:, None] * uu[None] - st[:, None] * vv[None]) * hist_w[:, None]
    dy = (st[:, None] * uu[None] + ct[:, None] * vv[None]) * hist_w[:, None]
    px, py = xs[:, None] + dx, ys[:, None] + dy
    rpad = int(np.ceil(_DESC_HALF_BINS * np.sqrt(2.0) * 3.0
                       * _max_sigma(cfg, n_gauss - 1))) + 1
    sgx, sgy = _sample_grad_win(gx, gy, H, ls, ys, xs, py, px, rpad, rect)
    mag = torch.sqrt(sgx * sgx + sgy * sgy)
    ang = torch.atan2(sgy, sgx) - theta[:, None]

    r2 = (uu * uu + vv * vv)[None]
    w = torch.exp(-r2 / (2.0 * (D / 2.0) ** 2)) * mag  # (N, P)
    rbin = vv[None] + (D / 2 - 0.5)
    cbin = uu[None] + (D / 2 - 0.5)
    obin = torch.remainder(ang / TWO_PI * 8.0, 8.0)

    rows = torch.arange(D, dtype=torch.float32, device=w.device)
    wr = torch.clamp(1.0 - (rbin[..., None] - rows).abs(), min=0.0)  # (1,P,4)
    wc = torch.clamp(1.0 - (cbin[..., None] - rows).abs(), min=0.0)
    do = obin[..., None] - torch.arange(8, dtype=torch.float32,
                                        device=w.device)
    do = do - 8.0 * torch.round(do / 8.0)
    wo = torch.clamp(1.0 - do.abs(), min=0.0)  # (N, P, 8)

    # einsum("ns,nsr,nsc,nso->nrco") as one batched product over samples
    wrc = (wr[:, :, :, None] * wc[:, :, None, :]).reshape(1, -1, D * D)
    desc = torch.bmm((w[..., None] * wrc).transpose(1, 2), wo)  # (N, 16, 8)
    desc = desc.reshape(desc.shape[0], -1)

    # Lowe normalization: L2, clip 0.2, L2, scaled like OpenCV (512)
    nrm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
    desc = desc / torch.clamp(nrm, min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    nrm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
    return 512.0 * desc / torch.clamp(nrm, min=1e-12)


@functools.lru_cache(maxsize=None)
def _octave_tables(shapes: tuple, origins: tuple, budgets: tuple,
                   upsample: bool, device: torch.device) -> tuple:
    """Per candidate: its octave rectangle (x0, y0, x1, y1) in canvas
    coordinates, and the octave's origin and scale to input coordinates."""
    rect = np.concatenate([
        np.broadcast_to(np.array([ox, oy, ox + Wl, oy + Hl], np.int64), (b, 4))
        for (Hl, Wl), (oy, ox), b in zip(shapes, origins, budgets)])
    oct_idx = np.concatenate([np.full(b, o) for o, b in enumerate(budgets)])
    scale = ((0.5 if upsample else 1.0) * 2.0**oct_idx).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (tuple(dev(rect[:, i]) for i in range(4)), dev(scale),
            dev(rect[:, 0].astype(np.float32)),
            dev(rect[:, 1].astype(np.float32)))


def _detect_canvas(dogs, gauss, budgets, cfg: SiftConfig):
    """Canvas-packed detection: one extrema mask, refine pass, gradient-map
    build and orientation/descriptor pass over all octaves. Returns (xs,
    ys, sizes, scores, angles, desc, valid) over every candidate slot."""
    n_layers = cfg.n_layers
    shapes = tuple(tuple(d.shape[-2:]) for d in dogs)
    apron = 4
    cg, origins = pack_canvas(list(gauss), apron)  # (L+3, Hc, Wc)
    cd, _ = pack_canvas(list(dogs), apron)  # (L+2, Hc, Wc)
    Hc, Wc = cd.shape[-2:]
    dev = cd.device

    prefilter = 0.5 * cfg.contrast_threshold / n_layers * 255.0
    ext = _extrema_mask(cd, prefilter)
    border = 5
    inb = interior_mask((Hc, Wc), shapes, origins, border=border,
                        device=dev) > 0
    resp = torch.where(ext & inb[None], cd[1:-1].abs(),
                       torch.zeros((), device=dev))

    c_ys, c_xs, c_ls, c_top = [], [], [], []
    for (Hl, Wl), (oy, ox), budget in zip(shapes, origins, budgets):
        top, ys_l, xs_l, lb = blocked_topk_2d(
            resp[:, oy:oy + Hl, ox:ox + Wl], budget)
        c_ys.append(ys_l + oy)
        c_xs.append(xs_l + ox)
        c_ls.append(lb + 1)  # layer in 1..L
        c_top.append(top)
    ys, xs, ls = torch.cat(c_ys), torch.cat(c_xs), torch.cat(c_ls)
    sel_valid = torch.cat(c_top) > 0.0
    rect, oct_scale, ox_pc, oy_pc = _octave_tables(
        shapes, origins, tuple(budgets), cfg.upsample, dev)

    ls, ys, xs, off, contr, converged, tr, det = _refine(cd, ls, ys, xs,
                                                         border, rect)
    contrast_ok = contr.abs() * n_layers >= cfg.contrast_threshold * 255.0
    r = cfg.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) * (r + 1) * det)
    ok = sel_valid & converged & contrast_ok & edge_ok

    fx = xs.float() + off[:, 0]
    fy = ys.float() + off[:, 1]
    fl = ls.float() + off[:, 2]
    sig_local = cfg.sigma * torch.pow(2.0, fl / n_layers)

    n_gauss = cg.shape[0]
    gx, gy = _grad_maps(cg)
    ang1, ang2, has2 = _orientations(gx, gy, Hc, n_gauss, ls, fy, fx,
                                     sig_local, cfg, rect)
    # secondary-peak duplicates, compacted over all octaves by response
    sec_cap = max(16, sum(budgets) // 2)
    sec_score = torch.where(ok & has2, contr.abs(),
                            torch.full_like(contr, -math.inf))
    top2, idx2 = topk_stable(sec_score, sec_cap)
    sec_ok = top2 > -math.inf

    def two(a):
        return torch.cat([a, a[idx2]])

    ang = torch.cat([ang1, ang2[idx2]])
    desc = _descriptors(gx, gy, Hc, n_gauss, two(ls), two(fy), two(fx),
                        two(sig_local), ang, cfg, tuple(two(b) for b in rect))
    scale = two(oct_scale)
    return ((two(fx) - two(ox_pc)) * scale, (two(fy) - two(oy_pc)) * scale,
            two(sig_local) * scale * 2.0, two(contr.abs()), ang, desc,
            torch.cat([ok, sec_ok]))


def sift_detect_and_compute(img: torch.Tensor,
                            config: SiftConfig = SiftConfig()) -> SiftFeatures:
    """SIFT features of one (H, W) float32 [0, 255] image: the
    config.nfeatures strongest by response over all octaves, in raster
    order (invalid slots last)."""
    n_oct = min(n_octaves_for(tuple(img.shape), config.upsample),
                config.max_image_octaves)
    budgets = octave_budgets(config, n_oct)
    gauss, dogs = build_scale_space(img, n_layers=config.n_layers,
                                    sigma=config.sigma,
                                    upsample=config.upsample)
    xs, ys, sizes, scores, angles, desc, valid = _detect_canvas(
        dogs, gauss, budgets, config)

    # global top-nfeatures by response (OpenCV retainBest)
    masked = torch.where(valid, scores, torch.full_like(scores, -1.0))
    top, idx = topk_stable(masked, min(config.nfeatures, masked.shape[0]))
    keep = top > 0.0
    # raster emission order on a quarter-pixel integer key; the matched
    # scale estimator and the unmatched one both rely on it (vo_tpu
    # frontend/sift.py:688-704)
    ry = torch.round(ys[idx] * 4.0).long()
    rx = torch.round(xs[idx] * 4.0).long()
    rast = torch.where(keep, ry * (4 * 16384) + rx,
                       torch.full_like(ry, 2**31 - 1))
    order = torch.argsort(rast, stable=True)
    idx, keep = idx[order], keep[order]

    def vz(a):
        return torch.where(keep, a[idx], torch.zeros_like(a[idx]))

    return SiftFeatures(xs=vz(xs), ys=vz(ys), sizes=vz(sizes),
                        scores=vz(scores), angles=vz(angles),
                        desc=desc[idx] * keep[:, None].float(), valid=keep)


def sift_pairs(ref, other):
    """Agreement of two detections of one image (numpy fields xs, ys,
    angles, desc, valid). For each of `ref`'s valid keypoints: whether
    `other` has one within 0.01 px, and the angle gap and relative
    descriptor gap to the nearest-angled of those (a keypoint with a
    secondary orientation peak is emitted twice at one position)."""
    va, vb = ref.valid, other.valid
    pa = np.stack([ref.xs, ref.ys], 1)[va]
    pb = np.stack([other.xs, other.ys], 1)[vb]
    aa, ab = ref.angles[va], other.angles[vb]
    da, db = ref.desc[va], other.desc[vb]
    near = np.abs(pa[:, None, :] - pb[None, :, :]).max(-1) < 0.01
    dang = np.abs((aa[:, None] - ab[None, :] + np.pi) % (2 * np.pi) - np.pi)
    dang = np.where(near, dang, np.inf)
    best = dang.argmin(1)
    rel = np.linalg.norm(da - db[best], axis=1) / np.maximum(
        np.linalg.norm(da, axis=1), 1e-30)
    return near.any(1), dang.min(1), rel
