"""Reference-shaped PyTorch ``state_dict`` <-> the port's parameter tree
(counterpart of ``lipreading_tpu/train/importer.py``).

The reference model is built of ``torch.nn`` modules (Conv3d stack ->
bidirectional ``nn.GRU`` -> Bahdanau ``nn.GRUCell`` attention decoder ->
linear CTC head, ``tests/torch_ref.py``). The port keeps the JAX package's
parameter layouts, so a reference checkpoint loads through the same tree:

    Linear      weight [out, in]          -> w [in, out] (transposed), b [out]
    Conv3d      weight [O, I, kT, kH, kW] -> w [kT, kH, kW, I, O] (DHWIO)
    GRU         weight_ih_l{k}(_reverse) [3H, in] -> w_ih [in, 3H]
                (transposed; the gate order r, z, n is the same), biases as is
    Embedding   weight [V, D]             -> table [V, D]
    BatchNorm   frozen (eval) statistics folded to a scale and a bias

``import_model`` gives the nested tree of float32 numpy arrays that the JAX
importer gives, and ``io.from_jax_params`` carries it into ``LipReader``
(``lipreader_from_state_dict`` does both). ``export_model_state_dict`` is
its inverse: the port's model or tree -> the reference-shaped
``state_dict``, bit for bit (pure transposes). Together they are the fp32
transcript parity gate: the reference model and the port decode the same
weights to the same strings.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _k(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def import_linear(sd: dict, prefix: str = "") -> dict:
    p = {"w": _np(sd[_k(prefix, "weight")]).T}
    if _k(prefix, "bias") in sd:
        p["b"] = _np(sd[_k(prefix, "bias")])
    return p


def import_conv3d(sd: dict, prefix: str = "") -> dict:
    w = _np(sd[_k(prefix, "weight")])             # [O, I, kT, kH, kW]
    p = {"w": np.transpose(w, (2, 3, 4, 1, 0))}   # -> DHWIO
    if _k(prefix, "bias") in sd:
        p["b"] = _np(sd[_k(prefix, "bias")])
    return p


def import_embedding(sd: dict, prefix: str = "") -> dict:
    return {"table": _np(sd[_k(prefix, "weight")])}


def import_gru_cell(sd: dict, prefix: str, layer: int = 0,
                    reverse: bool = False) -> dict:
    """One direction of one layer of an ``nn.GRU``."""
    sfx = f"_l{layer}" + ("_reverse" if reverse else "")
    return {
        "w_ih": _np(sd[_k(prefix, f"weight_ih{sfx}")]).T,
        "w_hh": _np(sd[_k(prefix, f"weight_hh{sfx}")]).T,
        "b_ih": _np(sd[_k(prefix, f"bias_ih{sfx}")]),
        "b_hh": _np(sd[_k(prefix, f"bias_hh{sfx}")]),
    }


def import_bigru(sd: dict, prefix: str, layers: int) -> dict:
    return {
        "layers": [
            {
                "fwd": import_gru_cell(sd, prefix, layer, False),
                "bwd": import_gru_cell(sd, prefix, layer, True),
            }
            for layer in range(layers)
        ]
    }


def import_batchnorm_as_scale_bias(sd: dict, prefix: str,
                                   eps: float = 1e-5) -> dict:
    """Fold a frozen (eval-mode) BatchNorm into a per-channel affine map:
    (x - mean) / sqrt(var + eps) * g + b = x * scale + bias with scale =
    g / sqrt(var + eps). It is not a normalisation: apply it with
    ``apply_frozen_bn``, not a group norm."""
    g = _np(sd[_k(prefix, "weight")])
    b = _np(sd[_k(prefix, "bias")])
    mean = _np(sd[_k(prefix, "running_mean")])
    var = _np(sd[_k(prefix, "running_var")])
    scale = g / np.sqrt(var + eps)
    return {"scale": scale, "bias": b - mean * scale}


def apply_frozen_bn(p: dict, x):
    """The folded BatchNorm on channel-last ``x`` (numpy or a tensor)."""
    if isinstance(x, torch.Tensor):
        return (x * torch.as_tensor(p["scale"], device=x.device)
                + torch.as_tensor(p["bias"], device=x.device))
    return x * p["scale"] + p["bias"]


def import_groupnorm(sd: dict, prefix: str = "") -> dict:
    return {"scale": _np(sd[_k(prefix, "weight")]),
            "bias": _np(sd[_k(prefix, "bias")])}


def import_grucell(sd: dict, prefix: str = "") -> dict:
    """``nn.GRUCell`` -> a GRU cell's leaves (the same r, z, n order)."""
    return {
        "w_ih": _np(sd[_k(prefix, "weight_ih")]).T,
        "w_hh": _np(sd[_k(prefix, "weight_hh")]).T,
        "b_ih": _np(sd[_k(prefix, "bias_ih")]),
        "b_hh": _np(sd[_k(prefix, "bias_hh")]),
    }


def import_model(sd: dict, cfg) -> dict:
    """A reference-shaped ``state_dict`` -> the whole parameter tree.

    The layout (prefix -> module):
        frontend.conv{0,1,2}        nn.Conv3d          (weight, bias)
        frontend.gn{0,1,2}          nn.GroupNorm       (weight, bias)
        frontend.proj               nn.Linear
        frontend.highway.{i}.h/.t   nn.Linear pairs
        encoder.gru                 nn.GRU(bidirectional=True, num_layers=K)
        ctc_head                    nn.Linear           [decoder ctc|hybrid]
        att_decoder.embed           nn.Embedding        [decoder attention|hybrid]
        att_decoder.attn_enc        nn.Linear(2H, A, bias=False)
        att_decoder.attn_dec        nn.Linear(H, A)
        att_decoder.attn_v          nn.Linear(A, 1, bias=False)
        att_decoder.gru             nn.GRUCell(H + 2H, H)
        att_decoder.out             nn.Linear(H + 2H, V)

    Every entry must be consumed (``num_batches_tracked`` aside): a gate
    that ignored a weight could not certify parity, so unknown keys raise.
    """
    m = cfg.model
    if m.frontend != "conv3d":
        raise ValueError(
            "import_model maps the reference-shaped conv3d frontend; "
            f"cfg.model.frontend={m.frontend!r} has no torch counterpart "
            "(train it natively via scripts/train.py)"
        )
    consumed: set[str] = set()

    def take(fn, prefix, **kw):
        out = fn(sd, prefix, **kw)
        # the keys under the prefix are consumed (importers only read)
        consumed.update(k for k in sd
                        if k == prefix or k.startswith(prefix + "."))
        return out

    params: dict = {
        "frontend": {
            "conv0": take(import_conv3d, "frontend.conv0"),
            "gn0": take(import_groupnorm, "frontend.gn0"),
            "conv1": take(import_conv3d, "frontend.conv1"),
            "gn1": take(import_groupnorm, "frontend.gn1"),
            "conv2": take(import_conv3d, "frontend.conv2"),
            "gn2": take(import_groupnorm, "frontend.gn2"),
            "proj": take(import_linear, "frontend.proj"),
            "highway": [
                {
                    "h": take(import_linear, f"frontend.highway.{i}.h"),
                    "t": take(import_linear, f"frontend.highway.{i}.t"),
                }
                for i in range(m.highway_layers)
            ],
        },
        "encoder": {
            "layers": [
                {
                    "fwd": take(import_gru_cell, "encoder.gru",
                                layer=layer, reverse=False),
                    "bwd": take(import_gru_cell, "encoder.gru",
                                layer=layer, reverse=True),
                }
                for layer in range(m.gru_layers)
            ]
        },
    }
    if cfg.decoder in ("ctc", "hybrid"):
        params["ctc_head"] = take(import_linear, "ctc_head")
    if cfg.decoder in ("attention", "hybrid"):
        params["att_decoder"] = {
            "embed": take(import_embedding, "att_decoder.embed"),
            "attn_enc": take(import_linear, "att_decoder.attn_enc"),
            "attn_dec": take(import_linear, "att_decoder.attn_dec"),
            "attn_v": take(import_linear, "att_decoder.attn_v"),
            "gru": take(import_grucell, "att_decoder.gru"),
            "out": take(import_linear, "att_decoder.out"),
        }
    leftover = [k for k in sd if k not in consumed
                and not k.endswith("num_batches_tracked")]
    if leftover:
        raise ValueError(
            f"state_dict keys not consumed by import_model: {sorted(leftover)}"
        )
    return params


def lipreader_from_state_dict(sd: dict, cfg,
                              device: str | torch.device = "cuda"):
    """A reference-shaped ``state_dict`` -> the port's ``LipReader`` on
    ``device``, in eval mode (``import_model``, then a strict load of
    ``io.from_jax_params``)."""
    from lipreading_tpu_torch.io import from_jax_params
    from lipreading_tpu_torch.models.lipreader import LipReader

    model = LipReader(cfg)
    model.load_state_dict(from_jax_params(import_model(sd, cfg), cfg))
    return model.to(device).eval()


def _seq(node) -> list:
    """A list of the tree, whether a list or a dict keyed "0", "1", ..."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def export_model_state_dict(params, cfg) -> dict:
    """The inverse of ``import_model``: the port's ``LipReader`` (or its
    parameter tree, lists or dicts keyed "0", "1", ...) -> a reference-shaped
    ``state_dict`` of CPU float32 tensors. Importing it gives back the tree
    bit for bit."""
    if cfg.model.frontend != "conv3d":
        raise ValueError(
            "export_model_state_dict maps the reference-shaped conv3d "
            f"frontend; cfg.model.frontend={cfg.model.frontend!r} has no "
            "torch counterpart"
        )
    if isinstance(params, torch.nn.Module):
        from lipreading_tpu_torch.io import to_jax_params

        params = to_jax_params(params.state_dict())

    sd: dict = {}

    def put(key, arr, transpose=False):
        a = np.asarray(arr, dtype=np.float32)
        sd[key] = torch.from_numpy(
            np.ascontiguousarray(a.T if transpose else a).copy()
        )

    fe = params["frontend"]
    for i in range(3):
        w = np.asarray(fe[f"conv{i}"]["w"], dtype=np.float32)   # DHWIO
        sd[f"frontend.conv{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2)))
        )
        put(f"frontend.conv{i}.bias", fe[f"conv{i}"]["b"])
        put(f"frontend.gn{i}.weight", fe[f"gn{i}"]["scale"])
        put(f"frontend.gn{i}.bias", fe[f"gn{i}"]["bias"])
    put("frontend.proj.weight", fe["proj"]["w"], transpose=True)
    put("frontend.proj.bias", fe["proj"]["b"])
    for i, hp in enumerate(_seq(fe["highway"])):
        for part in ("h", "t"):
            put(f"frontend.highway.{i}.{part}.weight", hp[part]["w"],
                transpose=True)
            put(f"frontend.highway.{i}.{part}.bias", hp[part]["b"])

    for layer, lp in enumerate(_seq(params["encoder"]["layers"])):
        for cell, sfx in ((lp["fwd"], f"_l{layer}"),
                          (lp["bwd"], f"_l{layer}_reverse")):
            put(f"encoder.gru.weight_ih{sfx}", cell["w_ih"], transpose=True)
            put(f"encoder.gru.weight_hh{sfx}", cell["w_hh"], transpose=True)
            put(f"encoder.gru.bias_ih{sfx}", cell["b_ih"])
            put(f"encoder.gru.bias_hh{sfx}", cell["b_hh"])

    if "ctc_head" in params:
        put("ctc_head.weight", params["ctc_head"]["w"], transpose=True)
        put("ctc_head.bias", params["ctc_head"]["b"])
    if "att_decoder" in params:
        ad = params["att_decoder"]
        put("att_decoder.embed.weight", ad["embed"]["table"])
        put("att_decoder.attn_enc.weight", ad["attn_enc"]["w"], transpose=True)
        put("att_decoder.attn_dec.weight", ad["attn_dec"]["w"], transpose=True)
        put("att_decoder.attn_dec.bias", ad["attn_dec"]["b"])
        put("att_decoder.attn_v.weight", ad["attn_v"]["w"], transpose=True)
        put("att_decoder.gru.weight_ih", ad["gru"]["w_ih"], transpose=True)
        put("att_decoder.gru.weight_hh", ad["gru"]["w_hh"], transpose=True)
        put("att_decoder.gru.bias_ih", ad["gru"]["b_ih"])
        put("att_decoder.gru.bias_hh", ad["gru"]["b_hh"])
        put("att_decoder.out.weight", ad["out"]["w"], transpose=True)
        put("att_decoder.out.bias", ad["out"]["b"])
    return sd


def load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint file -> its flat ``state_dict`` on the CPU (the
    ``state_dict`` entry of a dict that holds one)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj
