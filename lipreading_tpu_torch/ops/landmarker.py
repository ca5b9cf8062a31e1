"""Conv landmarker (counterpart of ``CROP``, ``LAYERS``, ``forward``,
``round_face_boxes`` and ``predict_batch_conv`` in
``lipreading_tpu/ops/landmarker.py``): a small convnet over the 64x64 face
crop regresses all 68 points at once, in place of the ERT cascade. It is the
landmarker of the default serving deployment (``landmarker=conv``).

    face box -> rounded int box -> 64x64 crop (the ROI kernel, normalize=0)
             -> 4 x (conv 3x3 stride 2 + relu) -> dense 256 + relu
             -> dense 136 -> landmarks in box units -> frame pixels

The convolutions use the JAX package's symmetric padding ``k // 2`` and run
in full float32 (cuDNN's TF32 off, as for the detector). JAX flattens the
NHWC activations, so the port's NCHW ones are permuted to NHWC before the
flatten that ``fc1/w`` reads. ``init_landmarker`` draws a fresh landmarker
(numpy, the JAX package's draw); ``preproc_training.train_conv_landmarker``
distils the ERT into it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lipreading_tpu_torch.ops import roi as roi_ops
from lipreading_tpu_torch.ops.detector import relu
from lipreading_tpu_torch.ops.roi import full_float32, true_div

CROP = 64

LAYERS = (
    ("conv1", 3, 1, 16, 2),
    ("conv2", 3, 16, 32, 2),
    ("conv3", 3, 32, 64, 2),
    ("conv4", 3, 64, 96, 2),
)
FC_DIM = 256


def init_landmarker(seed: int = 0, mean_shape: np.ndarray | None = None,
                    width: float = 1.0) -> dict[str, np.ndarray]:
    """Weights as a flat numpy dict in the JAX package's layout (HWIO
    convolutions), the same draw as its ``init_landmarker``. ``width``
    scales every channel count (to multiples of 8; the dense layer to
    multiples of 64); the output layer starts near zero with the mean shape
    as its bias, so the net starts at the mean shape."""
    rng = np.random.default_rng(np.random.SeedSequence([0x1A9D, seed]))
    params: dict[str, np.ndarray] = {}
    couts = [max(8, int(c * width + 0.5) // 8 * 8)
             for _, _, _, c, _ in LAYERS]
    cins = [LAYERS[0][2]] + couts[:-1]
    for (name, k, _, _, _), cin, cout in zip(LAYERS, cins, couts):
        fan_in = k * k * cin
        params[f"{name}/w"] = rng.normal(
            0, np.sqrt(2.0 / fan_in), size=(k, k, cin, cout)
        ).astype(np.float32)
        params[f"{name}/b"] = np.zeros(cout, dtype=np.float32)
    fc_dim = max(64, int(FC_DIM * width + 0.5) // 64 * 64)
    flat = (CROP // 16) * (CROP // 16) * couts[-1]
    params["fc1/w"] = rng.normal(
        0, np.sqrt(2.0 / flat), size=(flat, fc_dim)
    ).astype(np.float32)
    params["fc1/b"] = np.zeros(fc_dim, dtype=np.float32)
    params["out/w"] = rng.normal(0, 1e-3, size=(fc_dim, 136)).astype(np.float32)
    params["out/b"] = (
        mean_shape.astype(np.float32).reshape(136)
        if mean_shape is not None else np.full(136, 0.5, np.float32)
    )
    return params


def params_to_torch(params: dict[str, np.ndarray],
                    device: str | torch.device = "cuda"
                    ) -> dict[str, torch.Tensor]:
    """``landmarker_conv.npz`` arrays -> float32 tensors on ``device``, the
    convolutions' HWIO weights as OIHW."""
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.asarray(v, np.float32), device=device)
        out[k] = t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t
    return out


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Inverse of ``params_to_torch``: numpy arrays, convolutions as HWIO
    (the layout of ``landmarker_conv.npz``)."""
    return {k: (v.detach().permute(2, 3, 1, 0) if v.ndim == 4 else v.detach()
                ).contiguous().cpu().numpy() for k, v in params.items()}


def forward(params: dict[str, torch.Tensor], crop: torch.Tensor) -> torch.Tensor:
    """[B, 64, 64] gray crop (0..255) -> [B, 68, 2] landmarks in box units."""
    x = (true_div(crop.float(), 255.0) - 0.5) / 0.5
    x = x[:, None]                                         # NCHW
    with full_float32():
        for name, k, _, _, stride in LAYERS:
            x = F.conv2d(x, params[f"{name}/w"], stride=stride,
                         padding=k // 2)
            x = relu(x + params[f"{name}/b"][:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = relu(x @ params["fc1/w"] + params["fc1/b"])
        out = x @ params["out/w"] + params["out/b"]
    return out.reshape(-1, 68, 2)


def round_face_boxes(boxes: torch.Tensor, frame_h: int,
                     frame_w: int) -> torch.Tensor:
    """Float (x0, y0, size) [B, 3] -> int32 boxes rounded and shifted into
    the frame."""
    s = torch.floor(boxes[:, 2] + 0.5).int().clamp(2, min(frame_h, frame_w))
    x0 = torch.minimum(torch.floor(boxes[:, 0] + 0.5).int().clamp(min=0),
                       frame_w - s)
    y0 = torch.minimum(torch.floor(boxes[:, 1] + 0.5).int().clamp(min=0),
                       frame_h - s)
    return torch.stack([x0, y0, s], dim=1).int()


def predict_batch_conv(params: dict[str, torch.Tensor], gray: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
    """[B, H, W] gray + [B, 3] float face boxes -> [B, 68, 2] landmarks in
    pixels (the contract of ``ops.ert.predict_batch``). The crop is one
    launch of the ROI kernel on the card (its plain version on the CPU)."""
    B, H, W = gray.shape
    ibox = round_face_boxes(boxes, H, W)
    crop = roi_ops.sample_rois(gray.float().contiguous(), ibox, CROP,
                               normalize=False)
    lm = forward(params, crop)                             # box units
    origin = ibox[:, :2].float()[:, None, :]
    size = ibox[:, 2].float()[:, None, None]
    return origin + lm * size
