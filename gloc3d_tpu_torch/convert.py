"""Flax parameter trees → port ``state_dict``s, and BatchNorm folding.

``flax_to_state_dict`` is the inverse of the JAX package's converters
(``tools/convert_torch_checkpoint.py``: ``convert_pointpillar_checkpoint``,
``convert_vggvlad_checkpoint``; ``models/encoders.py::
convert_torchvision_encoder``): it takes a DescriptorModel's Flax ``{params,
batch_stats}`` (numpy or jax arrays; for PointPillar the folded tree with
``Conv_0``/``Dense_0`` biases and no BatchNorm too) and returns the
reference torch names the port uses. The caller names the encoder, as
``ModelConfig.encoder`` does: PointPillar (the default; with the pose head
``conv_out_pose`` where the tree has it, a model initialised in mode
"pose" or "both"), VGG16 (Flax
``conv0``-``conv12`` → ``encoder.{0,2,5,…,28}``), AlexNet, MobileNetV2 or
ResNet18 (torchvision's names). Layouts: conv HWIO → OIHW; Dense
``(in, out)`` → Conv1d ``(out, in, 1)``; VLAD assignment ``(D, K)`` →
``(K, D, 1, 1)``. The same PointPillar state dict loads into
``models/packed.py``'s ``PointPillarPacked`` and ``PointPillarSorted``.
``pose_state_dict`` does the same for the pose model of
``train/pose.py`` (``encoder`` in mode "pose" and ``pose_head``).

``load_reference_checkpoint`` reads a reference PyTorch checkpoint (a
``.pth.tar`` of the GLoc3D s2s model or of its VGGVLAD i2i model, saved as
``{'state_dict': ...}`` or as a bare state dict, with or without the
``module.`` prefix of ``nn.DataParallel``) into the same names, which are
the reference's own. ``load_reference_into`` loads it strictly into a
DescriptorModel and hands back, by name, the pose head
``encoder.conv_out_pose.*`` a reference s2s checkpoint may carry and the
descriptor model lacks; ``encoder_state_dict`` is the checkpoint's encoder
alone, which loads strictly into a ``PointPillar`` built with the heads the
checkpoint has (``mode="both"``).

``restore_params`` loads any checkpoint file the command line takes into
a DescriptorModel: the JAX package's path-encoded ``.npz``
(``params/...``, ``batch_stats/...``), its VGGVLAD ``.npz``
(``conv{i}_kernel``, ``pool_*``), a reference ``.pth.tar`` and the port
trainer's ``ckpt_*.pt``.

``fold_batch_norm`` ports ``gloc3d_tpu/models/fold.py``: each eval-mode BN
after a conv becomes the conv's scale and bias (same fp32 arithmetic as the
JAX fold), for the ``fold_bn=True`` serving model.

``grid_state_to_port`` carries an occupancy state across: a JAX
``OccupancyGrid3D``, ``ProbabilityGrid2D`` or ``Submap3D`` (the NamedTuple
itself, or a mapping of the same fields as numpy arrays and metadata)
becomes the port's, bit for bit; ``grid_state_to_numpy`` is its inverse,
the fields that JAX's constructors take.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from gloc3d_tpu_torch.core.device import resolve_device
from gloc3d_tpu_torch.models.encoders import (
    is_image_encoder, port_key, torchvision_state_dict)
from gloc3d_tpu_torch.models.vgg import VGG16_CONV_IDX
from gloc3d_tpu_torch.ops.occupancy import (
    OccupancyGrid3D, ProbabilityGrid2D, Submap3D)

_BN_EPS = 1e-5  # flax nn.BatchNorm default, matches torch

_BLOCKS = (("block1", 2), ("block2", 3), ("block3", 3))  # (name, layers)
_UPS = (("up1", 0), ("up2", 1), ("up3", 1))  # (name, torch conv index)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def load_reference_checkpoint(path_or_obj: Union[str, os.PathLike, Mapping]
                              ) -> Dict[str, torch.Tensor]:
    """A reference checkpoint → port state_dict, on the CPU.

    ``path_or_obj`` is a path that ``torch.load`` reads, or the object it
    returned: ``{'state_dict': sd, ...}`` (the reference's ``.pth.tar``) or
    ``sd`` itself. A leading ``module.`` is stripped from every key. Array
    values become tensors; names are unchanged otherwise (the port uses the
    reference's parameter names)."""
    obj = path_or_obj
    if isinstance(obj, (str, os.PathLike)):
        obj = torch.load(obj, map_location="cpu", weights_only=False)
    if not isinstance(obj, Mapping):
        raise TypeError(f"expected a state dict or {{'state_dict': ...}}, got "
                        f"{type(obj).__name__}")
    sd = obj.get("state_dict", obj)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        key = k[len("module."):] if k.startswith("module.") else k
        out[key] = (v.detach().cpu() if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v)))
    return out


POSE_HEAD = "encoder.conv_out_pose."


def load_reference_into(model: torch.nn.Module,
                        state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Load a reference state dict into ``model`` strictly, except for the
    pose head (``encoder.conv_out_pose.*``) when ``model`` has none: those
    entries are returned by name (the JAX converter likewise takes the head
    only where the model has it). Any other missing or unexpected key
    raises."""
    own = set(model.state_dict())
    rest = {k: v for k, v in state_dict.items()
            if k.startswith(POSE_HEAD) and k not in own}
    model.load_state_dict({k: v for k, v in state_dict.items()
                           if k not in rest})
    return rest


def encoder_state_dict(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The ``encoder.*`` entries of a model state dict with the prefix
    taken off: a ``PointPillar``'s (or an image encoder's) own."""
    return {k[len("encoder."):]: v for k, v in state_dict.items()
            if k.startswith("encoder.")}


def flax_to_state_dict(variables: Mapping, encoder: str = "pointpillar"
                       ) -> Dict[str, torch.Tensor]:
    """DescriptorModel Flax variables of ``encoder`` (a
    ``ModelConfig.encoder`` name) → port state_dict: any pooling; for
    PointPillar both ``fold_bn`` variants."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    enc_p, enc_s = params["encoder"], stats.get("encoder", {})
    pool = netvlad_state_dict(params.get("pool", {}), stats.get("pool"),
                              prefix="pool.")
    if encoder == "vgg16":
        out = {}
        for i, li in enumerate(VGG16_CONV_IDX):
            c = enc_p[f"conv{i}"]
            out[f"encoder.{li}.weight"] = _t(c["kernel"]).permute(
                3, 2, 0, 1).contiguous()
            out[f"encoder.{li}.bias"] = _t(c["bias"])
        return {**out, **pool}
    if is_image_encoder(encoder):
        tv = torchvision_state_dict(encoder, enc_p, enc_s)
        return {**{f"encoder.{port_key(encoder, k)}": v
                   for k, v in tv.items()}, **pool}
    if encoder != "pointpillar":
        raise ValueError(f"unknown encoder {encoder!r}")
    return {**pointpillar_state_dict(enc_p, enc_s), **pool}


def pointpillar_state_dict(enc_p: Mapping, enc_s: Mapping,
                           prefix: str = "encoder."
                           ) -> Dict[str, torch.Tensor]:
    """A Flax PointPillar's ``params`` and ``batch_stats`` (standard or
    folded; with whichever of the heads ``conv_out`` / ``conv_out_pose``
    it has) → port names under ``prefix``."""
    out: Dict[str, torch.Tensor] = {}

    def bn(pnode, snode, dst):
        if "BatchNorm_0" not in pnode:
            return  # folded tree
        out[f"{dst}.weight"] = _t(pnode["BatchNorm_0"]["scale"])
        out[f"{dst}.bias"] = _t(pnode["BatchNorm_0"]["bias"])
        out[f"{dst}.running_mean"] = _t(snode["BatchNorm_0"]["mean"])
        out[f"{dst}.running_var"] = _t(snode["BatchNorm_0"]["var"])
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def conv(pnode, snode, dst_conv, dst_bn):
        c = pnode["Conv_0"]
        out[f"{dst_conv}.weight"] = _t(c["kernel"]).permute(3, 2, 0, 1
                                                            ).contiguous()
        if "bias" in c:
            out[f"{dst_conv}.bias"] = _t(c["bias"])
        bn(pnode, snode, dst_bn)

    pn, pn_s = enc_p["pn"], enc_s.get("pn", {})
    out[f"{prefix}pn.pointnet.0.weight"] = _t(
        pn["Dense_0"]["kernel"]).t().contiguous()[:, :, None]
    if "bias" in pn["Dense_0"]:
        out[f"{prefix}pn.pointnet.0.bias"] = _t(pn["Dense_0"]["bias"])
    bn(pn, pn_s, f"{prefix}pn.pointnet.1")
    for name, n in _BLOCKS:
        for i in range(n):
            key = f"ConvBNRelu_{i}"
            conv(enc_p[name][key], enc_s.get(name, {}).get(key, {}),
                 f"{prefix}{name}.layers.{3 * i}",
                 f"{prefix}{name}.layers.{3 * i + 1}")
    for name, ci in _UPS:
        conv(enc_p[name], enc_s.get(name, {}), f"{prefix}{name}.{ci}",
             f"{prefix}{name}.{ci + 1}")
    for head in ("conv_out", "conv_out_pose"):
        if f"{head}_0" not in enc_p:
            continue  # Flax creates only the heads of the init mode
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            key = f"{head}_{j}"
            conv(enc_p[key], enc_s.get(key, {}), f"{prefix}{head}.{ci}",
                 f"{prefix}{head}.{bi}")
    return out


def pose_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``PosePairModel`` variables (``encoder``: a PointPillar
    initialised in mode "pose"; ``pose_head``) → the port's
    ``PosePairModel`` state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    return {**pointpillar_state_dict(params["encoder"],
                                     stats.get("encoder", {})),
            **pose_head_state_dict(params["pose_head"], stats["pose_head"])}


def pose_head_state_dict(params: Mapping, stats: Mapping,
                         prefix: str = "pose_head."
                         ) -> Dict[str, torch.Tensor]:
    """A Flax ``PoseHead``'s ``params`` and ``batch_stats`` (``Conv_0``,
    ``BatchNorm_0``, ``Dense_0``) → port names under ``prefix``."""
    bn, bn_s = params["BatchNorm_0"], stats["BatchNorm_0"]
    return {
        f"{prefix}conv.weight": _t(params["Conv_0"]["kernel"]).permute(
            3, 2, 0, 1).contiguous(),
        f"{prefix}bn.weight": _t(bn["scale"]),
        f"{prefix}bn.bias": _t(bn["bias"]),
        f"{prefix}bn.running_mean": _t(bn_s["mean"]),
        f"{prefix}bn.running_var": _t(bn_s["var"]),
        f"{prefix}bn.num_batches_tracked": torch.tensor(0),
        f"{prefix}fc.weight": _t(params["Dense_0"]["kernel"]).t(
        ).contiguous(),
        f"{prefix}fc.bias": _t(params["Dense_0"]["bias"]),
    }


def netvlad_state_dict(pool: Mapping, pool_stats: Optional[Mapping] = None,
                       prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax NetVLAD params (+ gating BN stats, or the gating biases of a
    ``GatingContext(add_batch_norm=False)``) → port NetVLAD state_dict
    (``prefix`` prepended); empty for the max/avg pooling heads."""
    out: Dict[str, torch.Tensor] = {}
    if "conv_weight" not in pool:
        return out
    out[f"{prefix}conv.weight"] = _t(pool["conv_weight"]).t().contiguous(
    )[:, :, None, None]
    if "conv_bias" in pool:
        out[f"{prefix}conv.bias"] = _t(pool["conv_bias"])
    out[f"{prefix}centroids"] = _t(pool["centroids"])
    if "hidden1_weights" in pool:
        out[f"{prefix}hidden1_weights"] = _t(pool["hidden1_weights"])
    if "context_gating" in pool:
        g = pool["context_gating"]
        cg = f"{prefix}context_gating."
        out[f"{cg}gating_weights"] = _t(g["gating_weights"])
        if "gating_biases" in g:  # GatingContext(add_batch_norm=False)
            out[f"{cg}gating_biases"] = _t(g["gating_biases"])
            return out
        g_s = (pool_stats or {})["context_gating"]["bn1"]
        out[f"{cg}bn1.weight"] = _t(g["bn1"]["scale"])
        out[f"{cg}bn1.bias"] = _t(g["bn1"]["bias"])
        out[f"{cg}bn1.running_mean"] = _t(g_s["mean"])
        out[f"{cg}bn1.running_var"] = _t(g_s["var"])
        out[f"{cg}bn1.num_batches_tracked"] = torch.tensor(0)
    return out


def fold_batch_norm(state_dict: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Standard-model state_dict → folded-model state_dict.

    Every encoder BatchNorm at Sequential index j folds into the conv at
    index j−1: ``weight' = weight·γ/√(σ²+ε)``, ``bias' = β − μ·γ/√(σ²+ε)``.
    The gating BN (``pool.context_gating.bn1``) follows no conv and stays,
    as in the JAX fold.
    """
    out = {k: v.clone() for k, v in state_dict.items()}
    bns = [k[: -len(".running_mean")] for k in state_dict
           if k.startswith("encoder.") and k.endswith(".running_mean")]
    for bn in bns:
        head, idx = bn.rsplit(".", 1)
        conv = f"{head}.{int(idx) - 1}"
        gamma = state_dict[f"{bn}.weight"].numpy().astype(np.float32)
        beta = state_dict[f"{bn}.bias"].numpy().astype(np.float32)
        mean = state_dict[f"{bn}.running_mean"].numpy().astype(np.float32)
        var = state_dict[f"{bn}.running_var"].numpy().astype(np.float32)
        inv = gamma / np.sqrt(var + np.float32(_BN_EPS))
        w = state_dict[f"{conv}.weight"].numpy().astype(np.float32)
        out[f"{conv}.weight"] = torch.from_numpy(
            w * inv.reshape((-1,) + (1,) * (w.ndim - 1)))
        out[f"{conv}.bias"] = torch.from_numpy(beta - mean * inv)
        for suffix in ("weight", "bias", "running_mean", "running_var",
                       "num_batches_tracked"):
            out.pop(f"{bn}.{suffix}", None)
    return out


def _field(state: Any, name: str):
    return state[name] if isinstance(state, Mapping) else getattr(state, name)


def _has(state: Any, name: str) -> bool:
    return name in state if isinstance(state, Mapping) else hasattr(
        state, name)


def grid_state_to_port(state: Any, device=None):
    """A JAX occupancy state → the port's on ``device`` (the card unless
    ``"cpu"`` is given): a ``Submap3D`` (fields ``high``, ``low``,
    ``num_range_data``), an ``OccupancyGrid3D`` (``log_odds``, ``known``,
    ``resolution``, ``half``) or a ``ProbabilityGrid2D`` (``log_odds``,
    ``known``, ``origin_xy``, ``resolution``). Arrays may be numpy or JAX
    arrays (read through ``np.asarray``)."""
    dev = resolve_device(device, "grid_state_to_port")
    if _has(state, "high"):
        return Submap3D(grid_state_to_port(_field(state, "high"), dev),
                        grid_state_to_port(_field(state, "low"), dev),
                        int(_field(state, "num_range_data")))
    lo = torch.from_numpy(np.array(_field(state, "log_odds"), np.float32)
                          ).to(dev)
    kn = torch.from_numpy(np.array(_field(state, "known"), bool)).to(dev)
    res = float(_field(state, "resolution"))
    if _has(state, "half"):
        return OccupancyGrid3D(lo, kn, res, tuple(
            int(h) for h in _field(state, "half")))
    origin = torch.from_numpy(np.array(_field(state, "origin_xy"),
                                       np.float32)).to(dev)
    return ProbabilityGrid2D(lo, kn, origin, res)


def grid_state_to_numpy(state) -> Dict[str, Any]:
    """The port's occupancy state → a dict of its fields, arrays as numpy
    (the inverse of ``grid_state_to_port``)."""
    if isinstance(state, Submap3D):
        return {"high": grid_state_to_numpy(state.high),
                "low": grid_state_to_numpy(state.low),
                "num_range_data": state.num_range_data}
    out = {"log_odds": state.log_odds.cpu().numpy(),
           "known": state.known.cpu().numpy(),
           "resolution": state.resolution}
    if isinstance(state, OccupancyGrid3D):
        out["half"] = tuple(state.half)
    else:
        out["origin_xy"] = state.origin_xy.cpu().numpy()
    return out


def _unflatten(data: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """``{"a/b/c": array}`` → ``{"a": {"b": {"c": array}}}``."""
    tree: Dict[str, Any] = {}
    for key, value in data.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree


def _vggvlad_variables(data: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """A VGGVLAD ``.npz`` of the JAX package's converter (``conv{i}_kernel``
    and ``_bias``, ``pool_conv_weight``, ``pool_centroids``,
    ``pool_hidden1_weights``, optionally ``pool_conv_bias``) → the Flax
    variables ``flax_to_state_dict(..., "vgg16")`` takes."""
    enc = {f"conv{i}": {"kernel": data[f"conv{i}_kernel"],
                        "bias": data[f"conv{i}_bias"]}
           for i in range(len(VGG16_CONV_IDX))}
    pool = {k[len("pool_"):]: data[k] for k in data if k.startswith("pool_")}
    return {"params": {"encoder": enc, "pool": pool}}


def restore_params(model: torch.nn.Module, path: str,
                   encoder: str = "pointpillar") -> torch.nn.Module:
    """Load the checkpoint at ``path`` into ``model`` in place:

    - ``.npz`` with ``params/...`` keys: the JAX package's path-encoded
      variables (``models/pointpillar.py::load_pointpillar_npz``);
    - another ``.npz``: a VGGVLAD checkpoint (``models/vgg.py::
      load_vggvlad_npz``);
    - ``.pt``: the port trainer's ``ckpt_*.pt`` (``{"model": ...}``);
    - anything else: a reference checkpoint (``.pth.tar``), loaded as
      ``load_reference_into`` loads it.

    From an ``.npz``, entries the model lacks are skipped and entries the
    file lacks keep their current values, as in JAX. A standard checkpoint
    loaded into a ``fold_bn=True`` model is folded first."""
    own = model.state_dict()
    if path.endswith(".npz"):
        with np.load(path) as f:
            data = {k: f[k] for k in f.files}
        variables = (_unflatten(data)
                     if any(k.startswith("params/") for k in data)
                     else _vggvlad_variables(data))
        sd = flax_to_state_dict(variables, encoder)
    elif path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)["model"]
    else:
        sd = load_reference_checkpoint(path)
    if not any(k.endswith(".running_mean") and k.startswith("encoder.")
               for k in own):
        sd = fold_batch_norm(sd)
    if path.endswith(".npz"):
        sd = {**own, **{k: v for k, v in sd.items() if k in own}}
        model.load_state_dict(sd)
    else:
        load_reference_into(model, sd)
    return model
