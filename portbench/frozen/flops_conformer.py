"""Frozen copy of the program's FLOP count of the Auto-AVSR family
(``lipreading_tpu_torch/flops.py``: ``resnet18_flops``,
``conformer_encoder_flops``, ``relpos_flops`` and the family's branch of
``model_fwd_flops`` and ``train_step_flops``), taking the configuration as
a dict; the CTC head and the decoder are ``frozen/flops.py``'s.
``tests/test_portbench_conformer.py`` holds it equal to the program's.
Matrix products and convolutions count 2 FLOPs a multiply-add."""

from __future__ import annotations

from portbench.frozen.flops import (
    _dense,
    conv3d_flops,
    ctc_head_flops,
    transformer_decoder_flops,
)

WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)
CONV_KERNEL = 31


def resnet18_flops(cfg: dict, T: int, crop: int | None = None) -> float:
    """Per-sample forward FLOPs of the ResNet-18 trunk over T frames of
    ``crop`` (default ``roi_size``) pixels a side."""
    C = crop or cfg["preprocess"]["roi_size"]
    f = conv3d_flops(T, C, C, (5, 7, 7), 1, WIDTHS[0], (1, 2, 2))
    s = -(-(-(-C // 2)) // 2)          # ceil(ceil(C / 2) / 2): conv0, pool
    cin = WIDTHS[0]
    for cout, stride in zip(WIDTHS, STRIDES):
        so = -(-s // stride)
        f += conv3d_flops(T, so, so, (1, 3, 3), cin, cout)
        f += 3 * conv3d_flops(T, so, so, (1, 3, 3), cout, cout)
        if stride != 1 or cin != cout:
            f += conv3d_flops(T, so, so, (1, 1, 1), cin, cout)
        s, cin = so, cout
    return f


def conformer_encoder_flops(cfg: dict, T: int) -> float:
    m = cfg["model"]
    D, M, K = m["tf_dim"], m["tf_mlp"], CONV_KERNEL
    per_block = (
        2 * (_dense(T, D, M) + _dense(T, M, D))
        + 4 * _dense(T, D, D)
        + 2.0 * T * T * D + 2.0 * T * (2 * T - 1) * D + 2.0 * T * T * D
        + _dense(T, D, 2 * D) + 2.0 * T * D * K + _dense(T, D, D)
    )
    return m["tf_layers"] * per_block + _dense(T, WIDTHS[-1], D)


def relpos_flops(cfg: dict, T: int) -> float:
    m = cfg["model"]
    return m["tf_layers"] * _dense(2 * T - 1, m["tf_dim"], m["tf_dim"])


def model_fwd_flops(cfg: dict, T: int, L: int,
                    crop: int | None = None) -> float:
    """Per-sample forward FLOPs: trunk, encoder, CTC head, decoder."""
    return (resnet18_flops(cfg, T, crop) + conformer_encoder_flops(cfg, T)
            + ctc_head_flops(cfg, T) + transformer_decoder_flops(cfg, T, L))


def train_step_flops(cfg: dict, B: int, T: int, L: int,
                     crop: int | None = None) -> float:
    """fwd + bwd ~= 3x fwd, the positions' projection once a batch."""
    return 3.0 * (B * model_fwd_flops(cfg, T, L, crop)
                  + relpos_flops(cfg, T))
