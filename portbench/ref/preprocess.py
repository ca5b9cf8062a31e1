"""Plain PyTorch reference of the serving path's tracked preprocessing:
frames [N, H, W, 3] uint8 -> Rec.601 gray -> bilinear resize to 64 x 64
-> the detector trunk (three 3 x 3 stride-2 convolutions, relu, padding
k // 2) and its 1 x 1 head -> the presence head's logits per 8 x 8 cell ->
the 4 best cells decoded to square face boxes -> the track over time (the
nearest confident candidate to the last box, the last confident box carried
through frames without one, leading ones back-filled) -> the face box
rounded into the frame -> a 64 x 64 crop -> the conv landmarker's 68 points
-> the mouth's square box, its margin added -> a 96 x 96 bilinear ROI at
sub-pixel taps, normalised. The weights are read from the ``.npz`` files
under ``assets/``; every product and convolution runs in float32 with TF32
off (``model.Prec`` "tf32" turns it on: the control)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.ref.model import Prec

RGB = (0.299, 0.587, 0.114)
DET_LAYERS = (("conv1", 2), ("conv2", 2), ("conv3", 2), ("head", 1))
LMK_LAYERS = ("conv1", "conv2", "conv3", "conv4")
GRID, CELL, ANCHOR = 8, 8, 32.0
DET_IN, CROP = 64, 64


def div(x, d):
    """Correctly rounded division by a constant."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def conv2d(x, w_hwio, b, stride):
    """NCHW x, HWIO weights, symmetric padding k // 2."""
    w = w_hwio.permute(3, 2, 0, 1)
    y = F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)
    return y + b[:, None, None]


def relu(x):
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def grayscale(frames):
    f = frames.float()
    return f[..., 0] * RGB[0] + f[..., 1] * RGB[1] + f[..., 2] * RGB[2]


def taps(start, size, src_dim, out, subpixel):
    """Per output pixel along one axis: (first tap index, weight of the
    second tap) of a box [start, start + size) sampled at ``out`` centres,
    each tap clamped into the box (integer boxes) or the frame
    (sub-pixel)."""
    start = start.float()[:, None]
    size = size.float()[:, None]
    j = torch.arange(out, dtype=torch.float32, device=start.device)[None]
    src = (j + 0.5) * div(size, float(out)) - 0.5
    src = torch.minimum(torch.maximum(src, torch.zeros_like(src)), size - 1)
    if subpixel:
        src = (src + start).clamp(0.0, float(src_dim - 1))
        i0 = torch.floor(src).clamp(0.0, float(src_dim - 2))
        frac = src - i0
    else:
        i0 = torch.minimum(torch.floor(src), (size - 2).clamp(min=0.0))
        frac = src - i0
        i0 = (i0 + start).clamp(0.0, float(src_dim - 2))
    return i0, frac


def weights(start, size, src_dim, out, subpixel):
    """[N, out, src_dim] two-tap interpolation matrices."""
    i0, frac = taps(start, size, src_dim, out, subpixel)
    cols = torch.arange(src_dim, dtype=torch.float32, device=i0.device)
    i0, frac = i0[..., None], frac[..., None]
    return (torch.where(cols == i0, 1.0 - frac, 0.0)
            + torch.where(cols == i0 + 1, frac, 0.0))


def crop(gray, boxes, out, subpixel):
    """gray [N, H, W] + boxes (x0, y0, size) -> [N, out, out]."""
    _, H, W = gray.shape
    wy = weights(boxes[:, 1], boxes[:, 2], H, out, subpixel)
    wx = weights(boxes[:, 0], boxes[:, 2], W, out, subpixel)
    return wy @ gray @ wx.transpose(1, 2)


def resize64(gray):
    """Full-frame bilinear resize [N, H, W] -> [N, 64, 64]."""
    N, H, W = gray.shape
    z = torch.zeros((1,), device=gray.device)

    def mat(n):
        return weights(z, torch.full((1,), float(n), device=gray.device), n,
                       DET_IN, False)[0]

    return mat(H) @ gray @ mat(W).T


def detector(det, gray64):
    """-> (trunk features [N, 8, 8, 32], head [N, 8, 8, 4])."""
    x = (div(gray64, 255.0) - 0.5) / 0.5
    x = x[:, None]
    feats = None
    for name, stride in DET_LAYERS:
        x = conv2d(x, det[f"{name}/w"], det[f"{name}/b"], stride)
        if name != "head":
            x = relu(x)
            feats = x
    return feats.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1)


def candidates(head, logits, H, W, k=4):
    """The k best cells by presence logit (ties: the lower cell) -> boxes
    [N, k, 3] (x0, y0, size) in frame pixels, logits [N, k]."""
    N = head.shape[0]
    s = logits.reshape(N, GRID * GRID)
    order = torch.sort(s, dim=1, descending=True, stable=True)
    top, idx = order.values[:, :k], order.indices[:, :k]
    sel = torch.gather(head.reshape(N, GRID * GRID, 4), 1,
                       idx[..., None].expand(N, k, 4))
    cy = torch.div(idx, GRID, rounding_mode="floor").float()
    cx = (idx % GRID).float()
    x = (cx + torch.sigmoid(sel[..., 1])) * CELL * (W / DET_IN)
    y = (cy + torch.sigmoid(sel[..., 2])) * CELL * (H / DET_IN)
    size = torch.exp(sel[..., 3]) * ANCHOR * (0.5 * (W / DET_IN + H / DET_IN))
    return torch.stack([x - size / 2, y - size / 2, size], -1), top


def track(boxes, conf, threshold=0.5):
    """boxes [B, T, K, 3], conf [B, T, K] -> (box [B, T, 3], valid [B, T])."""
    B, T, K, _ = boxes.shape
    have = torch.zeros(B, dtype=torch.bool, device=boxes.device)
    box = torch.zeros((B, 3), device=boxes.device)
    ar = torch.arange(B, device=boxes.device)
    out, valid, seen = [], [], []

    def centre(b):
        return torch.stack([b[..., 0] + b[..., 2] / 2,
                            b[..., 1] + b[..., 2] / 2], -1)

    for t in range(T):
        ok = conf[:, t] >= threshold
        d = torch.linalg.vector_norm(centre(boxes[:, t])
                                     - centre(box)[:, None], dim=-1)
        score = torch.where(have[:, None], -d, conf[:, t])
        score = torch.where(ok, score, torch.full_like(score, -1e30))
        pick = boxes[:, t][ar, torch.argmax(score, dim=1)]
        any_ok = ok.any(1)
        box = torch.where(any_ok[:, None], pick, box)
        have = have | any_ok
        out.append(box)
        valid.append(any_ok)
        seen.append(have)
    filled = [None] * T
    nxt = out[-1]
    for t in range(T - 1, -1, -1):
        filled[t] = torch.where(seen[t][:, None], out[t], nxt)
        nxt = torch.where(valid[t][:, None], out[t], nxt)
    return torch.stack(filled, 1), torch.stack(valid, 1)


def landmarks(lmk, gray, face):
    """Face boxes [N, 3] -> [N, 68, 2] pixels."""
    _, H, W = gray.shape
    s = torch.floor(face[:, 2] + 0.5).clamp(2, min(H, W))
    x0 = torch.minimum(torch.floor(face[:, 0] + 0.5).clamp(min=0), W - s)
    y0 = torch.minimum(torch.floor(face[:, 1] + 0.5).clamp(min=0), H - s)
    ibox = torch.stack([x0, y0, s], 1)
    x = (div(crop(gray, ibox, CROP, False), 255.0) - 0.5) / 0.5
    x = x[:, None]
    for name in LMK_LAYERS:
        x = relu(conv2d(x, lmk[f"{name}/w"], lmk[f"{name}/b"], 2))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = relu(x @ lmk["fc1/w"] + lmk["fc1/b"])
    pts = (x @ lmk["out/w"] + lmk["out/b"]).reshape(-1, 68, 2)
    return ibox[:, None, :2] + pts * ibox[:, None, 2:3]


def mouth_rois(gray, pts, pre):
    lips = pts[:, 48:68]
    mn, mx = lips.amin(1), lips.amax(1)
    c = (mn + mx) / 2
    size = (mx - mn).amax(1) * (1.0 + pre["roi_margin"])
    boxes = torch.stack([c[:, 0] - size / 2, c[:, 1] - size / 2, size], 1)
    roi = crop(gray, boxes, pre["roi_size"], True)
    return div(div(roi, 255.0) - pre["normalize_mean"], pre["normalize_std"])


def preprocess(frames, assets, pre, prec=None, block=2048):
    """frames [B, T, H, W, 3] uint8 (a tensor on the reference's device)
    -> (ROIs [B, T, R, R], valid [B, T])."""
    prec = prec or Prec()
    B, T, H, W, _ = frames.shape
    det, pres, lmk = assets["det"], assets["presence"], assets["lmk"]
    flat = frames.reshape(B * T, H, W, 3)
    with prec.flags():
        cands, confs = [], []
        for i in range(0, B * T, block):
            g = grayscale(flat[i:i + block])
            feats, head = detector(det, resize64(g))
            h = relu(feats @ pres["w1"] + pres["b1"])
            logit = h @ pres["w2"] + pres["b2"]
            bx, top = candidates(head, logit, H, W)
            cands.append(bx)
            confs.append(torch.sigmoid(top))
        box, valid = track(torch.cat(cands).reshape(B, T, -1, 3),
                           torch.cat(confs).reshape(B, T, -1))
        box = box.reshape(B * T, 3)
        rois = []
        for i in range(0, B * T, block):
            g = grayscale(flat[i:i + block])
            rois.append(mouth_rois(g, landmarks(lmk, g, box[i:i + block]),
                                   pre))
    R = pre["roi_size"]
    return torch.cat(rois).reshape(B, T, R, R), valid


def load_assets(assets_dir, device):
    from portbench.ref.weights import load_npz

    def dev(d):
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in d.items()}

    return {"det": dev(load_npz(f"{assets_dir}/detector.npz")),
            "presence": dev(load_npz(f"{assets_dir}/presence.npz")),
            "lmk": dev(load_npz(f"{assets_dir}/landmarker_conv.npz"))}
