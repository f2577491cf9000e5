"""The reference's released torch checkpoints -> port `state_dict`s.

Counterpart of `vspbfr_tpu/convert/torch_import.py`. Reads the released
artifacts (`style_encoder_decoder.pt`, `code_diffuser.pt`,
`restoration_net.pt`, `Arcface.pth`, torchvision's VGG16 with the LPIPS
lin weights, torchvision's InceptionV3) into the port's modules.

Design, as in the JAX package: each converter walks the PORT module's
`state_dict()` (where JAX walks the flax tree) and derives the reference
key of every entry with a name-translation function over the port's key
path (`convs.3.conv.weight` -> ("convs", "3", "conv", "weight"); flax's
`convs_3` is the port's `convs.3`), then fits the reference tensor to the
port shape (linear (out, in) -> (in, out); conv OIHW -> HWIO; mod-conv
(1, O, I, k, k) -> (k, k, I, O); NCHW buffers -> NHWC). Walking the port
module guarantees completeness: an entry whose reference key is missing
raises, so a conversion covers every parameter or fails. Reference keys
the module does not read (noise buffers, blur kernels, optimizer states,
the mapping MLP of a decoder built without one, Inception's `fc` /
`AuxLogits`) are ignored.

Equalized-lr parameters stay unscaled, as stored by torch: both the
reference and the port apply the 1/sqrt(fan_in) scale at use time.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Mapping

import torch
from torch import nn

# --------------------------------------------------------------------------
# generic machinery
# --------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> dict[str, Any]:
    """Load a reference checkpoint to a flat {key: tensor} dict (a
    `state_dict` entry is unwrapped; non-tensor entries are kept as they
    are). Reference files hold non-tensor entries (options, optimizer
    states), so this unpickles arbitrary objects (`weights_only=False`):
    load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: v.detach().cpu() if torch.is_tensor(v) else v
            for k, v in ckpt.items()}


def sub_state_dict(sd: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    """Filter `prefix.` keys and strip the prefix (the reference's
    `get_keys`, `e4e/models/psp.py:13-17`)."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def fit_tensor(arr, shape: tuple[int, ...], key: str) -> torch.Tensor:
    """Fit a reference tensor to a port shape via the known layout maps,
    tried in the JAX package's order."""
    t = torch.as_tensor(arr)
    shape = tuple(shape)
    if t.ndim == 2:
        # linear weights are (out, in) in torch and (in, out) here. Always
        # transpose: a square matrix would "fit" untransposed otherwise.
        if tuple(t.T.shape) == shape:
            return t.T
        raise ValueError(f"2D shape mismatch {tuple(t.shape)} vs {shape} "
                         f"for {key}")
    if tuple(t.shape) == shape:
        return t
    if t.ndim == 4:
        oihw = t.permute(2, 3, 1, 0)                     # conv OIHW -> HWIO
        if tuple(oihw.shape) == shape:
            return oihw
        nchw = t.permute(0, 2, 3, 1)                     # buffer NCHW -> NHWC
        if tuple(nchw.shape) == shape:
            return nchw
    if t.ndim == 5 and t.shape[0] == 1:                  # modulated conv
        m = t[0].permute(2, 3, 1, 0)
        if tuple(m.shape) == shape:
            return m
    if t.numel() == math.prod(shape):                    # e.g. (1,3,1,1)->(3,)
        return t.reshape(shape)
    raise ValueError(f"cannot fit reference tensor {tuple(t.shape)} to port "
                     f"{shape} for {key}")


def convert_tree(module: nn.Module, sd: Mapping[str, Any],
                 key_fn: Callable[[tuple[str, ...]], str]
                 ) -> dict[str, torch.Tensor]:
    """Fill every entry of `module`'s state_dict from the reference dict
    `sd`, the reference key given by `key_fn` of the port key's path. The
    result loads with `load_state_dict(strict=True)`."""
    out = {}
    for k, want in module.state_dict().items():
        tk = key_fn(tuple(k.split(".")))
        if tk not in sd:
            raise KeyError(f"reference key {tk!r} (for port key {k!r}) "
                           f"missing")
        out[k] = _copy(fit_tensor(sd[tk], want.shape, tk), want.dtype)
    return out


def _copy(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous CPU copy of `t` in `dtype` (never a view of the
    reference's storage)."""
    return torch.empty(tuple(t.shape), dtype=dtype).copy_(t)


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _leaf(name: str) -> str:
    return {"kernel": "weight", "alpha": "weight"}.get(name, name)


# --------------------------------------------------------------------------
# per-model key translators, over the port's key path
# --------------------------------------------------------------------------

def _style_mlp_key(prefix: str, names: tuple[str, ...]) -> str:
    # style.fc{i}.{weight,bias} -> style.{i+1}.*  (PixelNorm is style.0)
    return f"{prefix}.{int(names[0][2:]) + 1}.{names[1]}"


def _conv_layer_key(prefix: str, names: tuple[str, ...],
                    downsample: bool) -> str:
    # ConvLayer {conv, activate} -> torch Sequential indices (a Blur first
    # when it downsamples)
    base = 1 if downsample else 0
    if names[0] == "conv":
        return f"{prefix}.{base}.{_leaf(names[1])}"
    if names[0] == "activate":
        return f"{prefix}.{base + 1}.{names[1]}"
    raise KeyError(names)


def _smart_key(prefix: str, names: tuple[str, ...]) -> str:
    head = names[0]
    if head == "modulation":
        return f"{prefix}.modulation.{names[1]}"
    if head == "dilated":
        return f"{prefix}.ModulatedConv2ds.{names[1]}.weight"
    if head == "fusion":
        return _conv_layer_key(f"{prefix}.fusion", names[1:],
                               downsample=False)
    if head == "noise":
        return f"{prefix}.noise.weight"
    if head == "activate":
        return f"{prefix}.activate.bias"
    raise KeyError(names)


def _styled_conv_key(prefix: str, names: tuple[str, ...]) -> str:
    head = names[0]
    if head == "conv":
        if names[1] == "modulation":
            return f"{prefix}.conv.modulation.{names[2]}"
        return f"{prefix}.conv.weight"
    if head == "noise":
        return f"{prefix}.noise.weight"
    if head == "activate":
        return f"{prefix}.activate.bias"
    raise KeyError(names)


def _to_rgb_key(prefix: str, names: tuple[str, ...]) -> str:
    if names[0] == "conv":
        if names[1] == "modulation":
            return f"{prefix}.conv.modulation.{names[2]}"
        return f"{prefix}.conv.weight"
    if names[0] == "bias":
        return f"{prefix}.bias"
    raise KeyError(names)


def _large_conv_key(prefix: str, names: tuple[str, ...]) -> str:
    head = names[0]
    if head == "dilated":
        return f"{prefix}.dilated_convs.{names[1]}.{_leaf(names[2])}"
    if head == "fusion":
        return _conv_layer_key(f"{prefix}.fusion", names[1:],
                               downsample=False)
    if head == "activate":
        return f"{prefix}.activate.bias"
    raise KeyError(names)


def _generator_key(names: tuple[str, ...]) -> str:
    head = names[0]
    if head == "style":
        return _style_mlp_key("style", names[1:])
    if head == "const_input":
        return "input.input"
    if head == "conv1":
        return _styled_conv_key("conv1", names[1:])
    if head == "to_rgb1":
        return _to_rgb_key("to_rgb1", names[1:])
    if head == "convs":
        return _styled_conv_key(f"convs.{names[1]}", names[2:])
    if head == "to_rgbs":
        return _to_rgb_key(f"to_rgbs.{names[1]}", names[2:])
    raise KeyError(names)


def _restorenet_key(names: tuple[str, ...]) -> str:
    head = names[0]
    if head == "style":
        return _style_mlp_key("style", names[1:])
    if head == "conv1":
        return _smart_key("conv1", names[1:])
    if head == "to_rgb1":
        return _to_rgb_key("to_rgb1", names[1:])
    if head == "to_rgbs":
        return _to_rgb_key(f"to_rgbs.{names[1]}", names[2:])
    if head == "convs":
        n = int(names[1])
        # even = StyledConv (upsample), odd = SMART
        if n % 2 == 0:
            return _styled_conv_key(f"convs.{n}", names[2:])
        return _smart_key(f"convs.{n}", names[2:])
    if head == "encoder_convs":
        n = int(names[1])
        # even = SMART, odd = StyledConv_down
        if n % 2 == 0:
            return _smart_key(f"encoder_convs.{n}", names[2:])
        return _styled_conv_key(f"encoder_convs.{n}", names[2:])
    if head in ("down_from_big", "final_layer"):
        return _large_conv_key(head, names[1:])
    if head == "final_linear":
        return f"final_linear.0.{names[1]}"
    if head == "final_transfer":
        return f"final_transfer.{names[1]}"
    raise KeyError(names)


def _discriminator_key(names: tuple[str, ...], log_size: int) -> str:
    head = names[0]
    if head == "stem":
        return _conv_layer_key("encoder_input_convs", names[1:], False)
    if head == "res":
        prefix = f"encoder_convs.{log_size - int(names[1])}"
        sub = names[2]
        if sub in ("conv1", "conv2", "skip"):
            return _conv_layer_key(f"{prefix}.{sub}", names[3:],
                                   downsample=sub != "conv1")
        raise KeyError(names)
    if head == "final_conv":
        return _conv_layer_key("final_conv", names[1:], False)
    if head in ("final_linear0", "final_linear1"):
        return f"final_linear.{head[-1]}.{names[1]}"
    raise KeyError(names)


def _e4e_key(names: tuple[str, ...]) -> str:
    """Encoder4Editing and GradualStyleEncoder alike."""
    head = names[0]
    if head == "input_conv":
        return "input_layer.0.weight"
    if head == "input_bn":
        return f"input_layer.1.{_BN[names[1]]}"
    if head == "input_prelu":
        return "input_layer.2.weight"
    if head == "body":
        p = f"body.{names[1]}"
        sub = names[2]
        table = {"shortcut_conv": f"{p}.shortcut_layer.0.weight",
                 "shortcut_bn": f"{p}.shortcut_layer.1",
                 "bn1": f"{p}.res_layer.0",
                 "conv1": f"{p}.res_layer.1.weight",
                 "prelu": f"{p}.res_layer.2.weight",
                 "conv2": f"{p}.res_layer.3.weight",
                 "bn2": f"{p}.res_layer.4"}
        if sub in ("shortcut_bn", "bn1", "bn2"):
            return f"{table[sub]}.{_BN[names[3]]}"
        if sub == "se":
            return f"{p}.res_layer.5.{names[3]}.weight"
        return table[sub]
    if head == "style":
        p = f"styles.{names[1]}"
        sub = names[2]
        mc = re.fullmatch(r"conv(\d+)", sub)
        if mc:
            return f"{p}.convs.{2 * int(mc.group(1))}.{_leaf(names[3])}"
        if sub == "linear":
            return f"{p}.linear.{names[3]}"
        raise KeyError(names)
    if head in ("latlayer1", "latlayer2"):
        return f"{head}.{_leaf(names[1])}"
    raise KeyError(names)


def _code_diffuser_key(names: tuple[str, ...]) -> str:
    if names[0] != "block":
        raise KeyError(names)
    p = f"att_mapper.{names[1]}"
    sub = names[2]
    if sub in ("q", "k", "v"):
        return f"{p}.{sub}_matrix.weight"
    if sub == "attention_layer":
        return f"{p}.attention_layer.{names[3]}_matrix.weight"
    m = re.fullmatch(r"(gamma|beta)_(fc0|ln|fc1)", sub)
    if m:
        idx = {"fc0": 0, "ln": 1, "fc1": 3}[m.group(2)]
        leaf = {"kernel": "weight", "scale": "weight"}.get(names[3], names[3])
        return f"{p}.{m.group(1)}_.{idx}.{leaf}"
    raise KeyError(names)


def _resnet101_key(names: tuple[str, ...]) -> str:
    head = names[0]
    if head == "stem_conv":
        return "conv1.weight"
    if head == "stem_bn":
        return f"bn1.{_BN[names[1]]}"
    if head == "fc":
        return f"fc.{_leaf(names[1])}"
    if re.fullmatch(r"layer\d+", head):
        p = f"{head}.{names[1]}"
        sub = names[2]
        if sub == "down_conv":
            return f"{p}.downsample.0.weight"
        if sub == "down_bn":
            return f"{p}.downsample.1.{_BN[names[3]]}"
        if sub.startswith("bn"):
            return f"{p}.{sub}.{_BN[names[3]]}"
        return f"{p}.{sub}.weight"
    raise KeyError(names)


# torchvision vgg16.features conv indices per the port's (block, conv)
_VGG_IDX = {(0, 0): 0, (0, 1): 2, (1, 0): 5, (1, 1): 7,
            (2, 0): 10, (2, 1): 12, (2, 2): 14,
            (3, 0): 17, (3, 1): 19, (3, 2): 21,
            (4, 0): 24, (4, 1): 26, (4, 2): 28}


def _lpips_key(names: tuple[str, ...]) -> str:
    if names[0] == "vgg":
        m = re.fullmatch(r"conv(\d)", names[1])
        idx = _VGG_IDX[(int(m.group(1)), int(names[2]))]
        return f"features.{idx}.{_leaf(names[3])}"
    if re.fullmatch(r"lin\d", names[0]):
        return f"{names[0]}.model.1.weight"
    raise KeyError(names)


def _inception_key(names: tuple[str, ...]) -> str:
    # (Mixed_6b, branch7x7, 2, conv|bn, leaf) or (Conv2d_1a_3x3, conv|bn,
    # leaf): the port's chain entry "2" is torchvision's `branch7x7_2`
    *mods, sub, leaf = names
    parts = []
    for m in mods:
        if m.isdigit():
            parts[-1] += f"_{m}"
        else:
            parts.append(m)
    prefix = ".".join(parts)
    if sub == "conv":
        return f"{prefix}.conv.weight"
    return f"{prefix}.bn.{_BN[leaf]}"


# --------------------------------------------------------------------------
# public converters
# --------------------------------------------------------------------------

def _nchw_flat_in(w, c: int, h: int, wd: int) -> torch.Tensor:
    """Linear weight whose INPUT was a torch NCHW flatten -> reordered for
    the port's NHWC flatten: torch (out, c*h*w) -> port (h*w*c, out)."""
    w = torch.as_tensor(w)
    out = w.shape[0]
    return w.reshape(out, c, h, wd).permute(0, 2, 3, 1).reshape(out, -1).T


def _nchw_flat_out(w, b, c: int, h: int, wd: int):
    """Linear whose OUTPUT is viewed as torch (B, C, H, W); here (B, H, W,
    C)."""
    w, b = torch.as_tensor(w), torch.as_tensor(b)
    w2 = w.reshape(c, h, wd, -1).permute(1, 2, 0, 3).reshape(c * h * wd, -1)
    b2 = b.reshape(c, h, wd).permute(1, 2, 0).reshape(-1)
    return w2.T, b2


def _put(out: dict, key: str, value: torch.Tensor) -> None:
    out[key] = _copy(value, out[key].dtype)


def convert_stylegan2_generator(module, sd) -> dict[str, torch.Tensor]:
    """A `Generator` (with its mapping MLP when built with `mapping=True`)
    from the reference decoder's state_dict."""
    return convert_tree(module, sd, _generator_key)


def convert_restoration_net(module, sd) -> dict[str, torch.Tensor]:
    out = convert_tree(module, sd, _restorenet_key)
    # the encoder head crosses a flatten boundary (`models/RestoreNet.py:
    # 937-941`): final_linear consumes the NCHW-flattened 4x4 map,
    # final_transfer's output is viewed back to (B, C, 4, 4)
    ch4 = out["final_transfer.bias"].shape[0] // 16
    _put(out, "final_linear.weight",
         _nchw_flat_in(sd["final_linear.0.weight"], ch4, 4, 4))
    w2, b2 = _nchw_flat_out(sd["final_transfer.weight"],
                            sd["final_transfer.bias"], ch4, 4, 4)
    _put(out, "final_transfer.weight", w2)
    _put(out, "final_transfer.bias", b2)
    return out


def convert_discriminator(module, sd, size: int = 512
                          ) -> dict[str, torch.Tensor]:
    log_size = int(math.log2(size))
    out = convert_tree(module, sd, lambda n: _discriminator_key(n, log_size))
    # final_linear.0 consumes the NCHW-flattened 4x4 map
    # (`models/RestoreNet.py:1259-1262`)
    ch4 = out["final_linear0.bias"].shape[0]
    _put(out, "final_linear0.weight",
         _nchw_flat_in(sd["final_linear.0.weight"], ch4, 4, 4))
    return out


def convert_e4e_encoder(module, sd) -> dict[str, torch.Tensor]:
    """`Encoder4Editing` or the pSp `GradualStyleEncoder` (one key map)."""
    return convert_tree(module, sd, _e4e_key)


def convert_code_diffuser(module, sd) -> dict[str, torch.Tensor]:
    return convert_tree(module, sd, _code_diffuser_key)


def convert_resnet101(module, sd) -> dict[str, torch.Tensor]:
    return convert_tree(module, sd, _resnet101_key)


def convert_inception_v3(module, sd) -> dict[str, torch.Tensor]:
    """torchvision inception_v3 state_dict -> `InceptionV3Features` (the
    `fc` / `AuxLogits` entries are unused)."""
    return convert_tree(module, sd, _inception_key)


def convert_lpips(module, vgg_features_sd, lin_sd) -> dict[str, torch.Tensor]:
    """vgg_features_sd: torchvision vgg16 state_dict (features.*); lin_sd:
    the calibrated lin heads (`my_lpips/weights/v0.1/vgg.pth`)."""
    sd = dict(vgg_features_sd)
    sd.update(lin_sd)
    return convert_tree(module, sd, _lpips_key)


def convert_psp_checkpoint(psp_facade, ckpt) -> dict[str, torch.Tensor]:
    """The full `style_encoder_decoder.pt` (encoder + decoder + latent_avg)
    -> a `PSPFacade` state_dict (`e4e/models/psp.py:122-143`). `ckpt` is the
    file's path or its loaded dict. A 1-D `latent_avg` is tiled to
    n_latent rows. It is read from the state_dict or, as e4e's trainer
    saves it, beside a `state_dict` entry."""
    raw = (torch.load(ckpt, map_location="cpu", weights_only=False)
           if isinstance(ckpt, str) else ckpt)
    sd = raw["state_dict"] if "state_dict" in raw else raw
    if "latent_avg" not in sd and "latent_avg" in raw:
        sd = {**sd, "latent_avg": raw["latent_avg"]}
    enc = convert_e4e_encoder(psp_facade.encoder,
                              sub_state_dict(sd, "encoder"))
    dec = convert_stylegan2_generator(psp_facade.decoder,
                                      sub_state_dict(sd, "decoder"))
    latent_avg = torch.as_tensor(sd["latent_avg"]).detach().cpu()
    if latent_avg.ndim == 1:
        latent_avg = latent_avg[None].repeat(psp_facade.n_latent, 1)
    out = {f"encoder.{k}": v for k, v in enc.items()}
    out.update({f"decoder.{k}": v for k, v in dec.items()})
    out["latent_avg"] = _copy(latent_avg,
                              psp_facade.latent_avg.dtype)
    return {k: out[k] for k in psp_facade.state_dict()}
