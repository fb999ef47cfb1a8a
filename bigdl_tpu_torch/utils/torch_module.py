"""Torch7 ``.t7`` module trees to and from the port's modules
(``bigdl_tpu/utils/torch_module.py``: ``to_module`` :45, ``from_module``
:160, ``load_model`` :274, ``save_model`` :284; reference
``utils/TorchFile.scala:142-187`` and its ``write<Layer>`` family): load a
Torch7-serialised ``nn.*`` tree as a model on a device, and save a model so
that stock Torch7, the reference or the JAX package read it.

The file of a model is the JAX package's, byte for byte, for the same
weights: the same tables in the same order, Torch7's layouts (a
``Linear`` weight (out, in), a ``SpatialConvolution`` weight viewed 2-D as
(nOut, nIn * kH * kW), ``TorchFile.scala:482``), which are the port's own
but for that view.  Only NCHW models are written: a channels-last model's
boundary modules (``NCHWToNHWC``) and its NHWC layers raise, as the JAX
package's NHWC layers do (build it with ``layout="NCHW"``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device
from bigdl_tpu_torch.utils import torch_file
from bigdl_tpu_torch.utils.torch_file import LongStorage, TorchObject

# torch classes with no constructor arguments worth preserving
_PARAM_FREE = {
    "nn.Tanh": nn.Tanh, "nn.Sigmoid": nn.Sigmoid,
    "nn.LogSoftMax": nn.LogSoftMax, "nn.SoftMax": nn.SoftMax,
    "nn.SoftPlus": nn.SoftPlus, "nn.SoftSign": nn.SoftSign,
    "nn.Identity": nn.Identity, "nn.Abs": nn.Abs, "nn.Exp": nn.Exp,
    "nn.Square": nn.Square, "nn.Sqrt": nn.Sqrt,
    "nn.CAddTable": nn.CAddTable, "nn.FlattenTable": nn.FlattenTable,
    "nn.LogSigmoid": nn.LogSigmoid, "nn.TanhShrink": nn.TanhShrink,
}


def _f32(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _children(payload: Dict) -> List[Any]:
    mods = payload.get("modules") or {}
    if isinstance(mods, dict):
        return [mods[k] for k in sorted(mods)]
    return list(mods)


def _filled(container, payload, device):
    for c in _children(payload):
        container.add(to_module(c, device))
    return container


def to_module(obj: TorchObject, device: DeviceLike = "cuda") -> nn.Module:
    """A Torch7 ``nn.*`` object tree as a module on ``device``
    (reference ``TorchFile.readModule``, ``TorchFile.scala:142``); an
    unsupported class raises :class:`ValueError` naming it."""
    dev = default_device(device)
    cls, p = obj.torch_class, obj.payload
    if cls in _PARAM_FREE:
        return _PARAM_FREE[cls]()
    if cls == "nn.Sequential":
        return _filled(nn.Sequential(), p, dev)
    if cls == "nn.Concat":
        return _filled(nn.Concat(int(p["dimension"])), p, dev)
    if cls == "nn.ConcatTable":
        return _filled(nn.ConcatTable(), p, dev)
    if cls == "nn.Linear":
        w = _f32(p["weight"])                       # (out, in)
        b = p.get("bias")
        m = nn.Linear(w.shape[1], w.shape[0], with_bias=b is not None,
                      device=dev)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            if b is not None:
                m.bias.copy_(torch.from_numpy(_f32(b).ravel()))
        return m
    if cls in ("nn.SpatialConvolution", "nn.SpatialConvolutionMM"):
        n_in = int(p["nInputPlane"])
        n_out = int(p["nOutputPlane"])
        kw, kh = int(p["kW"]), int(p["kH"])
        w = _f32(p["weight"]).reshape(n_out, n_in, kh, kw)  # OIHW
        b = p.get("bias")
        return nn.SpatialConvolution(
            n_in, n_out, kw, kh, int(p["dW"]), int(p["dH"]),
            int(p.get("padW", 0)), int(p.get("padH", 0)),
            with_bias=b is not None, init_weight=w,
            init_bias=None if b is None else _f32(b).ravel(), device=dev)
    if cls == "nn.SpatialMaxPooling":
        m = nn.SpatialMaxPooling(int(p["kW"]), int(p["kH"]),
                                 int(p["dW"]), int(p["dH"]),
                                 int(p.get("padW", 0)), int(p.get("padH", 0)))
        return m.ceil() if p.get("ceil_mode") else m
    if cls == "nn.SpatialAveragePooling":
        return nn.SpatialAveragePooling(
            int(p["kW"]), int(p["kH"]), int(p["dW"]), int(p["dH"]),
            int(p.get("padW", 0)), int(p.get("padH", 0)),
            ceil_mode=bool(p.get("ceil_mode")),
            count_include_pad=bool(p.get("count_include_pad", True)))
    if cls in ("nn.BatchNormalization", "nn.SpatialBatchNormalization"):
        mean = _f32(p["running_mean"]).ravel()
        var = _f32(p["running_var"]).ravel()
        affine = bool(p.get("affine", p.get("weight") is not None))
        klass = (nn.SpatialBatchNormalization
                 if cls == "nn.SpatialBatchNormalization"
                 else nn.BatchNormalization)
        return klass(mean.shape[0], eps=float(p.get("eps", 1e-5)),
                     momentum=float(p.get("momentum", 0.1)), affine=affine,
                     init_weight=_f32(p["weight"]).ravel() if affine
                     else None,
                     init_bias=_f32(p["bias"]).ravel() if affine else None,
                     init_running_mean=mean, init_running_var=var,
                     device=dev)
    if cls == "nn.ReLU":
        return nn.ReLU()
    if cls == "nn.ReLU6":
        return nn.ReLU6()        # torch implements it as HardTanh(0, 6)
    if cls == "nn.HardTanh":
        return nn.HardTanh(float(p.get("min_val", -1.0)),
                           float(p.get("max_val", 1.0)))
    if cls == "nn.Threshold":
        return nn.Threshold(float(p.get("threshold", 1e-6)),
                            float(p.get("val", 0.0)))
    if cls == "nn.Dropout":
        return nn.Dropout(float(p.get("p", 0.5)))
    if cls == "nn.View":
        v = nn.View(*(int(s) for s in np.asarray(p["size"]).ravel()))
        if p.get("numInputDims"):
            v.set_num_input_dims(int(p["numInputDims"]))
        return v
    if cls == "nn.Reshape":
        return nn.Reshape([int(s) for s in np.asarray(p["size"]).ravel()],
                          batch_mode=p.get("batchMode"))
    if cls == "nn.SpatialZeroPadding":
        return nn.SpatialZeroPadding(int(p["pad_l"]), int(p["pad_r"]),
                                     int(p["pad_t"]), int(p["pad_b"]))
    raise ValueError(f"unsupported torch module class {cls}")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

_EMPTY = np.zeros((0,), dtype=np.float32)


def _general(table: Dict, dtype: str = "torch.FloatTensor") -> Dict:
    """(reference ``writeGeneralParameters``, ``TorchFile.scala:450``)."""
    table["gradInput"] = _EMPTY
    table["output"] = _EMPTY
    table["_type"] = dtype
    return table


def _modules(m: nn.Container) -> Dict:
    return {i + 1: from_module(c) for i, c in enumerate(m.layers)}


def from_module(m: nn.Module) -> TorchObject:
    """A module tree as Torch7 ``nn.*`` objects (reference
    ``TorchFile.writeObject``'s module cases); a module Torch7 has no class
    for, or an NHWC one, raises :class:`ValueError` naming it."""
    for cls, klass in _PARAM_FREE.items():
        if type(m) is klass:
            return TorchObject(cls, _general({}))
    if type(m) is nn.ReLU:
        return TorchObject("nn.ReLU", _general({"inplace": False}))
    if type(m) is nn.ReLU6:
        # torch7 ReLU6 extends HardTanh(0, 6): fields must be present or
        # stock torch errors on nil min_val at run time
        return TorchObject("nn.ReLU6", _general(
            {"min_val": 0.0, "max_val": 6.0, "inplace": False}))
    if type(m) in (nn.HardTanh, nn.Clamp):
        return TorchObject("nn.HardTanh", _general(
            {"min_val": float(m.min_value), "max_val": float(m.max_value),
             "inplace": False}))
    if isinstance(m, nn.Sequential):
        return TorchObject("nn.Sequential", _general(
            {"modules": _modules(m)}))
    if isinstance(m, nn.ConcatTable):
        return TorchObject("nn.ConcatTable", _general(
            {"modules": _modules(m)}))
    if isinstance(m, nn.Concat):
        return TorchObject("nn.Concat", _general(
            {"modules": _modules(m), "dimension": float(m.dimension)}))
    if getattr(m, "format", "NCHW") != "NCHW":
        raise ValueError(f"cannot export NHWC-format "
                         f"{type(m).__name__} to torch (NCHW only)")
    if isinstance(m, nn.SpatialConvolution):
        if m.n_group != 1:
            raise ValueError("nGroup is not supported in torch")
        w = _host(m.weight)                                   # OIHW
        t = _general({
            "nInputPlane": float(m.n_input_plane),
            "nOutputPlane": float(m.n_output_plane),
            "kW": float(m.kernel_w), "kH": float(m.kernel_h),
            "dW": float(m.stride_w), "dH": float(m.stride_h),
            "padW": float(m.pad_w), "padH": float(m.pad_h),
            # the reference writer views weight 2-D (TorchFile.scala:482)
            "weight": w.reshape(m.n_output_plane, -1),
            "gradWeight": np.zeros_like(w).reshape(m.n_output_plane, -1),
            "fInput": _EMPTY, "fGradInput": _EMPTY,
        })
        if m.bias is not None:
            t["bias"] = _host(m.bias)
            t["gradBias"] = np.zeros_like(t["bias"])
        return TorchObject("nn.SpatialConvolution", t)
    if isinstance(m, nn.Linear):
        t = _general({"weight": _host(m.weight),              # (out, in)
                      "gradWeight": np.zeros(
                          (m.output_size, m.input_size), np.float32)})
        if m.bias is not None:
            t["bias"] = _host(m.bias)
            t["gradBias"] = np.zeros_like(t["bias"])
        return TorchObject("nn.Linear", t)
    if isinstance(m, nn.SpatialMaxPooling):
        return TorchObject("nn.SpatialMaxPooling", _general({
            "kW": float(m.kw), "kH": float(m.kh),
            "dW": float(m.dw), "dH": float(m.dh),
            "padW": float(m.pad_w), "padH": float(m.pad_h),
            "ceil_mode": bool(m.ceil_mode), "indices": _EMPTY}))
    if isinstance(m, nn.SpatialAveragePooling):
        return TorchObject("nn.SpatialAveragePooling", _general({
            "kW": float(m.kw), "kH": float(m.kh),
            "dW": float(m.dw), "dH": float(m.dh),
            "padW": float(m.pad_w), "padH": float(m.pad_h),
            "ceil_mode": bool(m.ceil_mode),
            "count_include_pad": bool(m.count_include_pad),
            "divide": True}))
    if isinstance(m, nn.BatchNormalization):   # covers Spatial subclass
        t = _general({"running_mean": _host(m.running_mean),
                      "running_var": _host(m.running_var),
                      "eps": float(m.eps), "momentum": float(m.momentum),
                      "affine": bool(m.affine)})
        if m.affine:
            t["weight"] = _host(m.weight)
            t["bias"] = _host(m.bias)
            t["gradWeight"] = np.zeros_like(t["weight"])
            t["gradBias"] = np.zeros_like(t["bias"])
        cls = ("nn.SpatialBatchNormalization"
               if isinstance(m, nn.SpatialBatchNormalization)
               else "nn.BatchNormalization")
        return TorchObject(cls, t)
    if isinstance(m, nn.Threshold):
        return TorchObject("nn.Threshold", _general(
            {"threshold": float(m.th), "val": float(m.v), "inplace": False}))
    if isinstance(m, nn.Dropout):
        return TorchObject("nn.Dropout", _general(
            {"p": float(m.p), "noise": _EMPTY, "v2": True}))
    if isinstance(m, nn.View):
        # torch7 View:__init__ excludes inferred (-1) dims from numElements
        n_elem = float(np.prod([s for s in m.sizes if s >= 0]))
        t = _general({"size": LongStorage(m.sizes), "numElements": n_elem})
        if m.num_input_dims:
            t["numInputDims"] = float(m.num_input_dims)
        return TorchObject("nn.View", t)
    if isinstance(m, nn.Reshape):
        if any(s < 0 for s in m.size):
            # torch7 Reshape has no inferred-dim support; its nelement
            # check would silently mis-branch on a negative product
            raise ValueError("cannot export Reshape with an inferred (-1) "
                             "dim to torch (use View instead)")
        return TorchObject("nn.Reshape", _general(
            {"size": LongStorage(m.size),
             "nelement": float(np.prod(m.size)),
             "batchMode": m.batch_mode}))
    if isinstance(m, nn.SpatialZeroPadding):
        return TorchObject("nn.SpatialZeroPadding", _general(
            {"pad_l": float(m.pl), "pad_r": float(m.pr),
             "pad_t": float(m.pt), "pad_b": float(m.pb)}))
    raise ValueError(f"cannot export {type(m).__name__} to torch")


def load_model(path: str, device: DeviceLike = "cuda") -> nn.Module:
    """Load a ``.t7`` file holding a Torch7 ``nn`` module tree onto
    ``device`` (reference ``Module.loadTorch``); raises without CUDA unless
    ``device="cpu"``."""
    dev = default_device(device)
    obj = torch_file.load(path)
    if not isinstance(obj, TorchObject):
        raise ValueError(f"{path} does not contain a torch module "
                         f"(got {type(obj).__name__})")
    return to_module(obj, dev)


def save_model(path: str, model: nn.Module) -> None:
    """Save a module tree as a Torch7-readable ``.t7`` (reference
    ``AbstractModule.saveTorch``)."""
    torch_file.save(path, from_module(model))
