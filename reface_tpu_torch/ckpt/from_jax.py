"""JAX package param trees -> the port's state_dicts.

The inverse of reface_tpu/ckpt/convert.py: each function takes one tower's
flax param tree (nested dicts of numpy arrays, with or without the top
"params" level) and returns the port module's state_dict, keyed by the
reference torch checkpoint's names. The naming rules are copied from
convert.py (`_unet_rule`, `_vae_rule`, `_clip_rule`, `_arcface_rule`,
`_bisenet_rule`), not imported, so this package never loads JAX.

A gradient tree of the same params (jax.grad of a loss over them) has the
same paths and layouts and converts the same way, so the tests compare the
two packages' gradients by name.

Layouts: Dense kernel (in, out) -> weight (out, in); Conv kernel
(kh, kw, in, out) -> weight (out, in, kh, kw); norm scale/bias ->
weight/bias; ArcFace's and the landmark head's NHWC-flatten fc rows ->
NCHW-flatten order.
BatchNorm's `num_batches_tracked` (absent from the flax tree) becomes 0.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import numpy as np
import torch

__all__ = ["unet_from_jax", "vae_from_jax", "clip_conditioner_from_jax",
           "arcface_from_jax", "conditioner_from_jax", "lpips_from_jax",
           "landmark_head_from_jax", "swap_from_jax", "bisenet_from_jax",
           "landmark_net_from_jax", "clip_vision_from_jax", "resnet50_from_jax",
           "hopenet_from_jax", "facerecon_from_jax", "discriminator_from_jax"]

_ID = lambda a: a
_NORM = {"scale": "weight", "bias": "bias"}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def _linear(w):
    return w.T


def _conv(w):
    return w.transpose(3, 2, 0, 1)


def _xform(leaf: str, kind: str) -> Callable:
    if leaf == "kernel":
        return _linear if kind == "linear" else _conv
    return _ID


def _tw(leaf: str) -> str:
    return "weight" if leaf in ("kernel", "scale") else "bias"


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _convert(tree: Mapping, rule) -> dict[str, torch.Tensor]:
    if "params" in tree:
        tree = tree["params"]
    sd = {}
    for path, arr in _flatten(tree).items():
        key, fn = rule(list(path))
        sd[key] = _tensor(fn(np.asarray(arr)))
        if key.endswith(".running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    return sd


# ---------------------------------------------------------------- UNet

def _unet_rule(p):
    leaf, top = p[-1], p[0]
    if top in ("time_embed_0", "time_embed_2"):
        return f"time_embed.{top[-1]}.{_tw(leaf)}", _xform(leaf, "linear")
    if top == "out_norm":
        return f"out.0.{_NORM[leaf]}", _ID
    if top == "out_conv":
        return f"out.2.{_tw(leaf)}", _xform(leaf, "conv")
    if top == "input_blocks_0_0" and len(p) == 2:
        return f"input_blocks.0.0.{_tw(leaf)}", _xform(leaf, "conv")
    m = re.match(r"middle_block_(\d+)$", top)
    if m:
        group, tprefix = "middle_block", f"middle_block.{m.group(1)}"
    else:
        m = re.match(r"(input_blocks|output_blocks)_(\d+)_(\d+)$", top)
        if not m:
            raise ValueError(f"unrecognized unet module {top}")
        group = m.group(1)
        tprefix = f"{group}.{m.group(2)}.{m.group(3)}"
    child, tw = p[1], _tw(leaf)
    res_map = {
        "in_norm": ("in_layers.0", "norm"),
        "in_conv": ("in_layers.2", "conv"),
        "emb_proj": ("emb_layers.1", "linear"),
        "out_norm": ("out_layers.0", "norm"),
        "out_conv": ("out_layers.3", "conv"),
        "skip": ("skip_connection", "conv"),
    }
    if child in res_map:
        tsub, kind = res_map[child]
        if kind == "norm":
            return f"{tprefix}.{tsub}.{_NORM[leaf]}", _ID
        return f"{tprefix}.{tsub}.{tw}", _xform(leaf, kind)
    if child == "conv":  # Downsample is `.op` in torch, Upsample `.conv`
        tsub = "op" if group == "input_blocks" else "conv"
        return f"{tprefix}.{tsub}.{tw}", _xform(leaf, "conv")
    if child == "norm":
        return f"{tprefix}.norm.{_NORM[leaf]}", _ID
    if child in ("proj_in", "proj_out"):
        return f"{tprefix}.{child}.{tw}", _xform(leaf, "conv")
    m2 = re.match(r"block_(\d+)$", child)
    if m2:
        bt = f"{tprefix}.transformer_blocks.{m2.group(1)}"
        gchild = p[2]
        if gchild in ("norm1", "norm2", "norm3"):
            return f"{bt}.{gchild}.{_NORM[leaf]}", _ID
        if gchild in ("attn1", "attn2"):
            tname = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v",
                     "to_out": "to_out.0"}[p[3]]
            return f"{bt}.{gchild}.{tname}.{tw}", _xform(leaf, "linear")
        if gchild == "ff":
            tname = {"proj_in": "ff.net.0.proj", "proj_out": "ff.net.2"}[p[3]]
            return f"{bt}.{tname}.{tw}", _xform(leaf, "linear")
    raise ValueError(f"unmapped unet path {'/'.join(p)}")


def unet_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, _unet_rule)


# ---------------------------------------------------------------- VAE

def _vae_rule(p):
    leaf, top = p[-1], p[0]
    tw = _tw(leaf)
    if top in ("quant_conv", "post_quant_conv"):
        return f"{top}.{tw}", _xform(leaf, "conv")
    tower, child = top, p[1]

    def resnet(tprefix, sub):
        if sub.startswith("norm"):
            return f"{tprefix}.{sub}.{_NORM[leaf]}", _ID
        return f"{tprefix}.{sub}.{tw}", _xform(leaf, "conv")

    m = re.match(r"(down|up)_(\d+)_block_(\d+)$", child)
    if m:
        return resnet(f"{tower}.{m.group(1)}.{m.group(2)}.block.{m.group(3)}", p[2])
    m = re.match(r"(down|up)_(\d+)_(downsample|upsample)$", child)
    if m:
        return (f"{tower}.{m.group(1)}.{m.group(2)}.{m.group(3)}.conv.{tw}",
                _xform(leaf, "conv"))
    if child == "mid_attn_1":
        if p[2] == "norm":
            return f"{tower}.mid.attn_1.norm.{_NORM[leaf]}", _ID
        return f"{tower}.mid.attn_1.{p[2]}.{tw}", _xform(leaf, "conv")
    if re.match(r"mid_block_\d$", child):
        return resnet(f"{tower}.mid.{child[4:]}", p[2])
    if child == "norm_out":
        return f"{tower}.norm_out.{_NORM[leaf]}", _ID
    if child in ("conv_in", "conv_out"):
        return f"{tower}.{child}.{tw}", _xform(leaf, "conv")
    raise ValueError(f"unmapped vae path {'/'.join(p)}")


def vae_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, _vae_rule)


# ---------------------------------------------------------------- CLIP

def _clip_rule(p):
    leaf, top = p[-1], p[0]
    tw = _tw(leaf)
    V = "model.vision_model"
    if top == "tower":
        child = p[1]
        if child == "class_embedding":
            return f"{V}.embeddings.class_embedding", _ID
        if child == "position_embedding":
            return f"{V}.embeddings.position_embedding.weight", _ID
        if child == "patch_embed":
            return f"{V}.embeddings.patch_embedding.weight", _conv
        if child == "pre_layernorm":
            return f"{V}.pre_layrnorm.{_NORM[leaf]}", _ID  # HF's typo'd key
        if child == "post_layernorm":
            return f"{V}.post_layernorm.{_NORM[leaf]}", _ID
        if child == "visual_projection":
            return "model.visual_projection.weight", _linear
        m = re.match(r"layer_(\d+)$", child)
        if m:
            L = f"{V}.encoder.layers.{m.group(1)}"
            sub = p[2]
            if sub in ("ln1", "ln2"):
                tn = {"ln1": "layer_norm1", "ln2": "layer_norm2"}[sub]
                return f"{L}.{tn}.{_NORM[leaf]}", _ID
            if sub == "attn":
                return f"{L}.self_attn.{p[3]}.{tw}", _xform(leaf, "linear")
            if sub in ("fc1", "fc2"):
                return f"{L}.mlp.{sub}.{tw}", _xform(leaf, "linear")
    if top == "mapper2":
        idx = re.match(r"block_(\d+)$", p[1]).group(1)
        B = f"mapper2.resblocks.{idx}"
        tn, kind = {
            "ln1": ("ln_1", "norm"),
            "ln2": ("ln_2", "norm"),
            "c_qkv": ("attn.c_qkv", "linear"),
            "c_proj": ("attn.c_proj", "linear"),
            "mlp_fc": ("mlp.c_fc", "linear"),
            "mlp_proj": ("mlp.c_proj", "linear"),
        }[p[2]]
        if kind == "norm":
            return f"{B}.{tn}.{_NORM[leaf]}", _ID
        return f"{B}.{tn}.{tw}", _xform(leaf, "linear")
    if top == "final_ln2":
        return f"final_ln2.{_NORM[leaf]}", _ID
    raise ValueError(f"unmapped clip path {'/'.join(p)}")


def clip_conditioner_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, _clip_rule)


def clip_vision_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A standalone CLIPVisionTower's params (eval's CLIP_B32) -> the port's
    CLIPVisionTower state dict (`vision_model.*`, `visual_projection.*`)."""
    def rule(p):
        key, fn = _clip_rule(["tower"] + p)
        return key[len("model."):], fn

    return _convert(tree, rule)


# ---------------------------------------------------------------- ArcFace

def _nhwc_flat_to_nchw_flat(kernel, side: int = 7):
    """Dense kernel over an NHWC-flattened (side,side,C) map -> torch Linear
    weight over the NCHW-flattened (C,side,side) map."""
    w = kernel.T  # (out, side*side*C)
    o = w.shape[0]
    c = w.shape[1] // (side * side)
    return w.reshape(o, side, side, c).transpose(0, 3, 1, 2).reshape(o, -1)


def _arcface_rule(p):
    leaf, top = p[-1], p[0]
    if top == "input_conv":
        return "input_layer.0.weight", _conv
    if top == "input_bn":
        return f"input_layer.1.{_BN_LEAF[leaf]}", _ID
    if top == "input_prelu":
        return "input_layer.2.weight", _ID
    if top == "output_bn":
        return f"output_layer.0.{_BN_LEAF[leaf]}", _ID
    if top == "output_fc":
        if leaf == "kernel":
            return "output_layer.3.weight", _nhwc_flat_to_nchw_flat
        return "output_layer.3.bias", _ID
    if top == "output_bn1d":
        return f"output_layer.4.{_BN_LEAF[leaf]}", _ID
    m = re.match(r"body_(\d+)$", top)
    if m:
        B = f"body.{m.group(1)}"
        sub = p[1]
        conv_map = {
            "shortcut_conv": f"{B}.shortcut_layer.0.weight",
            "conv1": f"{B}.res_layer.1.weight",
            "conv2": f"{B}.res_layer.3.weight",
        }
        if sub in conv_map:
            return conv_map[sub], _conv
        if sub == "prelu":
            return f"{B}.res_layer.2.weight", _ID
        bn_map = {"shortcut_bn": "shortcut_layer.1", "bn0": "res_layer.0",
                  "bn2": "res_layer.4"}
        if sub in bn_map:
            return f"{B}.{bn_map[sub]}.{_BN_LEAF[leaf]}", _ID
        if sub == "se":
            return f"{B}.res_layer.5.{p[2]}.weight", _conv
    raise ValueError(f"unmapped arcface path {'/'.join(p)}")


def arcface_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    return _convert(tree, _arcface_rule)


# ---------------------------------------------------------------- LPIPS

# the flax tap index -> torchvision's alexnet.features conv index
_ALEX_CONV_IDX = {0: 0, 1: 3, 2: 6, 3: 8, 4: 10}


def _lpips_rule(p):
    leaf, top = p[-1], p[0]
    if top == "alex":
        idx = _ALEX_CONV_IDX[int(re.match(r"conv(\d)$", p[1]).group(1))]
        return f"net.layers.{idx}.{_tw(leaf)}", _xform(leaf, "conv")
    m = re.match(r"lin(\d)$", top)
    if m:
        return f"lin.{m.group(1)}.1.weight", _conv
    raise ValueError(f"unmapped lpips path {'/'.join(p)}")


def lpips_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """nn/lpips.py LPIPS params -> the port's LPIPS state_dict, which is also
    a layout reface_tpu/ckpt/convert.py:convert_lpips reads back."""
    return _convert(tree, _lpips_rule)


# ------------------------------------------------ landmark auxiliary head

_LM_HEAD_CHANNELS = 128  # the head's conv width, the fc's channel count


def _landmark_head_rule(p):
    leaf, top = p[-1], p[0]
    if top == "conv":
        return f"conv.{_tw(leaf)}", _xform(leaf, "conv")
    if top == "fc":
        if leaf != "kernel":
            return "fc.bias", _ID
        side = lambda k: int(round((k.shape[0] // _LM_HEAD_CHANNELS) ** 0.5))
        return "fc.weight", lambda k: _nhwc_flat_to_nchw_flat(k, side(k))
    raise ValueError(f"unmapped landmark head path {'/'.join(p)}")


def landmark_head_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """LandmarkAuxHead params -> the port's state_dict; the flax head
    flattens NHWC before fc, the port NCHW."""
    return _convert(tree, _landmark_head_rule)


# ---------------------------------------------------------------- BiSeNet

def _bisenet_rule(p):
    """Flax BiSeNet path -> face-parsing checkpoint key (the `cp.` prefix
    for the context path's modules)."""
    leaf, top = p[-1], p[0]

    def bn(tprefix):
        return f"{tprefix}.{_BN_LEAF[leaf]}", _ID

    def conv(tprefix):
        return f"{tprefix}.weight", _conv

    def convbn(tprefix, sub):  # a ConvBN's children: conv / bn
        return conv(f"{tprefix}.conv") if sub == "conv" else bn(f"{tprefix}.bn")

    if top == "resnet":
        child, R = p[1], "cp.resnet"
        if child == "conv1":
            return conv(f"{R}.conv1")
        if child == "bn1":
            return bn(f"{R}.bn1")
        m = re.match(r"layer(\d)_(\d)$", child)
        if m:
            B, sub = f"{R}.layer{m.group(1)}.{m.group(2)}", p[2]
            if sub in ("conv1", "conv2"):
                return conv(f"{B}.{sub}")
            if sub in ("bn1", "bn2"):
                return bn(f"{B}.{sub}")
            if sub == "down_conv":
                return conv(f"{B}.downsample.0")
            if sub == "down_bn":
                return bn(f"{B}.downsample.1")
    if top in ("arm16", "arm32"):
        A, sub = f"cp.{top}", p[1]
        if sub == "conv":
            return convbn(f"{A}.conv", p[2])
        if sub == "conv_atten":
            return conv(f"{A}.conv_atten")
        if sub == "bn_atten":
            return bn(f"{A}.bn_atten")
    if top in ("conv_avg", "conv_head16", "conv_head32"):
        return convbn(f"cp.{top}", p[1])
    if top == "ffm":
        if p[1] == "convblk":
            return convbn("ffm.convblk", p[2])
        return conv(f"ffm.{p[1]}")
    if top in ("conv_out", "conv_out16", "conv_out32"):
        if p[1] == "conv":
            return convbn(f"{top}.conv", p[2])
        return conv(f"{top}.conv_out")
    raise ValueError(f"unmapped bisenet path {'/'.join(p)}")


def bisenet_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """nn/bisenet.py BiSeNet params -> the port's BiSeNet state_dict, keyed
    as the face-parsing checkpoint."""
    return _convert(tree, _bisenet_rule)


# ---------------------------------------------------- PatchGAN discriminator

def _discriminator_rule(grads: bool):
    """conv0 -> main.0, conv{n} -> main.{3n-1}, norm{n} -> main.{3n}, head ->
    main.{3 * n_layers + 2}. The flax norm stores its scale as the offset
    from 1 (its init is N(0, 0.02) + 1 at use), so a parameter tree's scale
    gains 1 and a gradient tree's is taken as it is."""
    def rule(p, n_layers):
        leaf, top = p[-1], p[0]
        if top == "head":
            return f"main.{3 * n_layers + 2}.{_tw(leaf)}", _xform(leaf, "conv")
        m = re.match(r"(conv|norm)(\d+)$", top)
        if not m:
            raise ValueError(f"unmapped discriminator path {'/'.join(p)}")
        n = int(m.group(2))
        if m.group(1) == "conv":
            return f"main.{max(3 * n - 1, 0)}.{_tw(leaf)}", _xform(leaf, "conv")
        shift = (lambda a: a) if grads or leaf != "scale" else (lambda a: a + 1.0)
        return f"main.{3 * n}.{_NORM[leaf]}", shift
    return rule


def discriminator_from_jax(tree: Mapping, grads: bool = False) -> dict[str, torch.Tensor]:
    """nn/discriminator.py NLayerDiscriminator params (or, grads=True, a
    gradient tree of them) -> the port's state_dict under taming's names."""
    inner = tree["params"] if "params" in tree else tree
    n_layers = sum(1 for k in inner if k.startswith("norm"))
    rule = _discriminator_rule(grads)
    return _convert(tree, lambda p: rule(p, n_layers))


# ------------------------------------------------------------ LandmarkNet

def _landmark_net_rule(p):
    """block_i/{down,conv}, fuse, heat: convs; block_i/{norm,norm2} and
    fuse_norm: a GroupNorm32, whose flax GroupNorm is GroupNorm_0."""
    leaf, top = p[-1], p[0]
    if top.startswith("block_"):
        sub = p[1]
        if sub in ("norm", "norm2"):
            return f"{top}.{sub}.{_NORM[leaf]}", _ID
        return f"{top}.{sub}.{_tw(leaf)}", _xform(leaf, "conv")
    if top == "fuse_norm":
        return f"fuse_norm.{_NORM[leaf]}", _ID
    if top in ("fuse", "heat"):
        return f"{top}.{_tw(leaf)}", _xform(leaf, "conv")
    raise ValueError(f"unmapped landmark net path {'/'.join(p)}")


def landmark_net_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """nn/landmarks.py LandmarkNet params -> the port's LandmarkNet
    state_dict."""
    return _convert(tree, _landmark_net_rule)


# ------------------------------------------------------ whole conditioner

_PROJ = {"proj_out_source": "proj_out_source",
         "proj_out_target": "proj_out_target",
         "id_proj_out": "ID_proj_out",
         "landmark_proj_out": "landmark_proj_out"}


# ------------------------------------------------------ ResNet-50 evals

def _resnet50_rule(p):
    """reface_tpu/eval/backbones.py's ResNet50 (under "trunk" in Hopenet and
    FaceReconCoeffNet) -> torchvision's names (convert.py `_resnet50_rule`)."""
    if p[0] == "trunk":
        p = p[1:]
    leaf, top = p[-1], p[0]
    if top == "conv1":
        return "conv1.weight", _conv
    if top == "bn1":
        return f"bn1.{_BN_LEAF[leaf]}", _ID
    if top in ("fc_yaw", "fc_pitch", "fc_roll"):
        return f"{top}.{_tw(leaf)}", _xform(leaf, "linear")
    m = re.match(r"layer(\d)_(\d+)$", top)
    if m:
        B = f"layer{m.group(1)}.{m.group(2)}"
        sub = p[1]
        if sub in ("conv1", "conv2", "conv3"):
            return f"{B}.{sub}.weight", _conv
        if sub in ("bn1", "bn2", "bn3"):
            return f"{B}.{sub}.{_BN_LEAF[leaf]}", _ID
        if sub == "down_conv":
            return f"{B}.downsample.0.weight", _conv
        if sub == "down_bn":
            return f"{B}.downsample.1.{_BN_LEAF[leaf]}", _ID
    raise ValueError(f"unmapped resnet50 path {'/'.join(p)}")


def resnet50_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """ResNet50's or Hopenet's params (the trunk and the fc_yaw / fc_pitch /
    fc_roll heads) -> the port's state dict."""
    return _convert(tree, _resnet50_rule)


hopenet_from_jax = resnet50_from_jax


def facerecon_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """FaceReconCoeffNet's params -> the port's state dict: the trunk by
    torchvision's names, the Dense `fc` (2048, 257) split back into the
    reference's seven 1x1 heads `final_layers.0-6` (id 80, exp 64, tex 80,
    angle 3, gamma 27, txy 2, tz 1)."""
    from reface_tpu_torch.eval.backbones import D3DFR_HEADS

    if "params" in tree:
        tree = tree["params"]
    sd = _convert({k: v for k, v in tree.items() if k != "fc"}, _resnet50_rule)
    kernel, bias = np.asarray(tree["fc"]["kernel"]), np.asarray(tree["fc"]["bias"])
    lo = 0
    for i, n in enumerate(D3DFR_HEADS):
        sd[f"final_layers.{i}.weight"] = _tensor(kernel[:, lo:lo + n].T[:, :, None, None])
        sd[f"final_layers.{i}.bias"] = _tensor(bias[lo:lo + n])
        lo += n
    return sd


def conditioner_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """REFaceConditioner params -> the port's REFaceConditioner state_dict
    (the REFace checkpoint's top-level names)."""
    if "params" in tree:
        tree = tree["params"]
    sd = {}
    for k, v in clip_conditioner_from_jax(tree["clip_embed"]).items():
        sd[f"cond_stage_model.{k}"] = v
    for k, v in arcface_from_jax(tree["face_id"]).items():
        sd[f"face_ID_model.facenet.{k}"] = v
    for flax_name, torch_name in _PROJ.items():
        sd[f"{torch_name}.weight"] = _tensor(np.asarray(tree[flax_name]["kernel"]).T)
        sd[f"{torch_name}.bias"] = _tensor(tree[flax_name]["bias"])
    sd["learnable_vector"] = _tensor(tree["learnable_vector"])
    return sd


def swap_from_jax(tree: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX package's {"unet", "vae", "conditioner"} params (or gradients)
    -> the port's {"unet", "vae", "conditioner"} state dicts, the `params`
    of FaceSwapper and of the trainer's init_state; the full loss's "lpips"
    and "landmark_head" trees are carried where the tree holds them."""
    out = {"unet": unet_from_jax(tree["unet"]), "vae": vae_from_jax(tree["vae"]),
           "conditioner": conditioner_from_jax(tree["conditioner"])}
    for name, fn in (("lpips", lpips_from_jax),
                     ("landmark_head", landmark_head_from_jax)):
        if name in tree:
            out[name] = fn(tree[name])
    return out
