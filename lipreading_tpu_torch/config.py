"""Configuration dataclasses of the lip-reading system.

A copy of the fields of ``lipreading_tpu/config.py``, so that a release's
``.json`` sidecar loads unchanged through ``from_dict`` and a config written
here (a training workdir's, an exported release's) reads the same in the
JAX package. The mesh section lays out multi-GPU training
(``parallel/mesh.py``).

The port alone adds the ``loss`` field, the one setting of the Auto-AVSR
family (``frontend="resnet18"``, ``encoder="conformer"``; Ma et al. 2023,
arXiv:2303.14307) that no JAX field holds. ``to_dict`` leaves it out while
it holds its default, so every release, preset and workdir config writes
the JAX package's dict.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any


@dataclass
class PreprocessConfig:
    """Video -> mouth-ROI preprocessing."""

    roi_size: int = 96            # output ROI is roi_size x roi_size grayscale
    roi_margin: float = 0.30      # mouth bbox expansion factor before square-crop
    normalize_mean: float = 0.421  # gray in [0,1] -> (x - mean) / std
    normalize_std: float = 0.165
    detector_input: int = 64      # face detector input resolution (square)
    ert_cascades: int = 10        # ERT landmark cascade stages
    ert_trees: int = 96           # boosted trees per cascade (parallel-friendly)
    ert_depth: int = 4            # split depth per tree (2^d leaves)
    ert_pool: int = 128           # candidate feature pixels per cascade
    # "ert" (the regression-tree cascade) or "conv" (the distilled conv
    # landmarker)
    landmarker: str = "ert"
    # ROI crop-box coordinates: "round" = integer boxes (the golden-dump
    # contract), "subpixel" = the float mouth box, "auto" = subpixel
    # whenever the landmarker is not the ERT
    roi_sampling: str = "auto"


@dataclass
class DataConfig:
    fps: float = 25.0
    frame_height: int = 160
    frame_width: int = 160
    frames_per_char: int = 4      # synthetic fixture speech rate
    max_frames: int = 128         # T bucket ceiling (static-shape padding)
    max_chars: int = 40           # L bucket ceiling incl. sos/eos
    time_buckets: tuple[int, ...] = (32, 64, 96, 128)
    batch_size: int = 8


@dataclass
class ModelConfig:
    # visual stem: "patchify" (tubelet embed) or "conv3d" (the Conv3d
    # stack of the reference, the releases' bi-GRU and transformer_hybrid*)
    frontend: str = "conv3d"
    frontend_channels: tuple[int, ...] = (32, 64, 96)
    frontend_dim: int = 256       # feature dim fed to the encoder
    patch_size: int = 8           # patchify stem: space-to-depth patch edge
    patch_dim: int = 256          # patchify stem: embed/conv channel width
    # per-frame GroupNorm statistics in the frontend; off pools them over
    # time, padded frames included. Weights trained one way must be decoded
    # the same way (models/nn.groupnorm).
    framewise_norm: bool = False
    highway_layers: int = 2
    # bi-GRU encoder
    gru_hidden: int = 256
    gru_layers: int = 2
    # attention decoder
    attn_dim: int = 128
    decoder_hidden: int = 256
    # transformer encoder-decoder
    tf_layers: int = 4
    tf_dec_layers: int = 4
    tf_dim: int = 256
    tf_heads: int = 4
    tf_mlp: int = 1024
    dropout: float = 0.1
    vocab_size: int = 31
    dtype: str = "bfloat16"       # activation dtype; params stay fp32
    # flash attention in the encoder's self-attention (O(T * Dh) memory,
    # ops/flash_attention.py) and its backward: "auto", "xla", "pallas"
    # (the two-pass kernels) or "fused"
    flash_attention: bool = False
    flash_bwd: str = "auto"


@dataclass
class TrainConfig:
    seed: int = 0
    learning_rate: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 5000
    weight_decay: float = 1e-4
    grad_clip: float = 5.0
    teacher_forcing: float = 1.0
    ctc_weight: float = 1.0       # hybrid CTC/attention loss mix
    att_weight: float = 0.0
    checkpoint_every: int = 500
    eval_every: int = 500
    log_every: int = 50
    beam_width: int = 8
    length_penalty: float = 0.6   # GNMT-style; 0 disables length norm
    max_decode_len: int = 48
    remat: bool = False           # recompute the frontend in the backward
    roi_augment: float = 0.0      # train-time ROI appearance jitter


@dataclass
class MeshConfig:
    """The mesh of ranks training runs over (``parallel/mesh.make_mesh``):
    data x model, the model axis carrying tensor parallelism, or sequence
    parallelism (ring attention) or a GPipe pipeline of
    ``pipeline_microbatches`` (0: one per stage). The axis names are the
    JAX package's, kept so a config reads the same in both."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1
    sequence_parallel: bool = False
    pipeline_parallel: bool = False
    pipeline_microbatches: int = 0


@dataclass
class Config:
    name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    encoder: str = "bigru"        # "bigru" | "transformer" | "conformer"
    decoder: str = "ctc"          # "ctc" | "attention" | "hybrid"
    # the loss terms' form: "mean" (the releases': CTC the mean over samples
    # of the per-label NLL, cross-entropy the mean over target tokens) or
    # "espnet" (ESPnet's, as Auto-AVSR trains: each term summed over the
    # batch and divided by the number of clips, the decoder's cross-entropy
    # label-smoothed by ``models/lipreader.LABEL_SMOOTHING``)
    loss: str = "mean"

    def override(self, **dotted: Any) -> "Config":
        """Apply dotted-path overrides, e.g. ``override(**{"train.seed": 3})``;
        a string value is coerced to the field's type."""
        cfg = dataclasses.replace(self)
        for key, value in dotted.items():
            parts = key.split(".")
            obj = cfg
            for p in parts[:-1]:
                if not is_dataclass(getattr(obj, p, None)):
                    raise KeyError(f"no config field {key!r}")
                child = dataclasses.replace(getattr(obj, p))
                setattr(obj, p, child)
                obj = child
            leaf = parts[-1]
            if not hasattr(obj, leaf):
                raise KeyError(f"no config field {key!r}")
            cur = getattr(obj, leaf)
            if cur is not None and not isinstance(value, type(cur)):
                value = _coerce(value, cur)
            setattr(obj, leaf, value)
        return cfg

    def to_dict(self) -> dict:
        """Every field; the port-only ``loss`` only where it is not its
        default (the module doc)."""
        d = dataclasses.asdict(self)
        if self.loss == "mean":
            del d["loss"]
        return d


def load_workdir_config(workdir: str) -> Config | None:
    """The config a ``Trainer`` wrote to ``workdir/config.json``, or None
    where there is none."""
    import json
    import os

    path = os.path.join(workdir, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return from_dict(json.load(f))


def _coerce(value: Any, like: Any) -> Any:
    t = type(like)
    if t is bool:
        return str(value).lower() in ("1", "true", "yes")
    if t is tuple:
        items = str(value).strip("()[] ").split(",")
        elem = type(like[0]) if like else int
        return tuple(elem(i) for i in items if i.strip())
    return t(value)


def parse_overrides(argv: list[str]) -> dict[str, str]:
    """``['train.seed=3', ...]`` -> ``{'train.seed': '3', ...}``."""
    out = {}
    for a in argv:
        if "=" not in a:
            raise ValueError(f"override must be key=value, got {a!r}")
        k, v = a.split("=", 1)
        out[k] = v
    return out


def preset(name: str) -> Config:
    """A named configuration of the JAX package's ``preset``. Its
    ``oracle-single-clip`` and ``preprocess-batched`` build no model of
    their own (they are the default config under another name), and
    ``dp-v5e8`` is data-parallel training over 8 devices; none of the
    three is here."""
    presets = {
        # conv3d stem, 2-layer bi-GRU, CTC head: the JAX package's default
        # model (the bigru_ctc release)
        "bigru-ctc": Config(name="bigru-ctc", encoder="bigru",
                            decoder="ctc"),
        # conv3d stem, transformer encoder and decoder, hybrid loss (the
        # transformer_hybrid* releases)
        "transformer-attn": Config(
            name="transformer-attn",
            encoder="transformer",
            decoder="hybrid",
            train=TrainConfig(ctc_weight=0.3, att_weight=0.7),
        ),
        # the flagship training configuration: patchify stem, transformer
        # encoder, hybrid CTC/attention loss
        "transformer-patchify": Config(
            name="transformer-patchify",
            encoder="transformer",
            decoder="hybrid",
            model=ModelConfig(frontend="patchify"),
            train=TrainConfig(ctc_weight=0.3, att_weight=0.7),
        ),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; have {sorted(presets)}")
    return presets[name]


def from_dict(d: dict) -> Config:
    """Rebuild a Config from ``to_dict()`` output (a release's ``config``)."""
    def build(cls, sub):
        kwargs = {}
        for f in fields(cls):
            if f.name not in sub:
                continue
            v = sub[f.name]
            if is_dataclass(f.type) if isinstance(f.type, type) else False:
                kwargs[f.name] = build(f.type, v)
            elif isinstance(v, list):
                kwargs[f.name] = tuple(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    cfg = Config(
        name=d.get("name", "default"),
        data=build(DataConfig, d.get("data", {})),
        preprocess=build(PreprocessConfig, d.get("preprocess", {})),
        model=build(ModelConfig, d.get("model", {})),
        train=build(TrainConfig, d.get("train", {})),
        mesh=build(MeshConfig, d.get("mesh", {})),
        encoder=d.get("encoder", "bigru"),
        decoder=d.get("decoder", "ctc"),
        loss=d.get("loss", "mean"),
    )
    return cfg
