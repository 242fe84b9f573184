"""Lower a parsed ONNX graph to a PyTorch function (port of
april_asr_tpu/ops/onnx2jax.py).

This is the universal execution path for `.april` models: whatever graph the
exporter traced (reference: extra/export-april.py:226-332 traces icefall
modules with torch.onnx at opset 11), it runs here node by node in eager
PyTorch. The native path (models/extract.py) pattern-matches known
architectures out of the same graphs for the port's kernels; this
interpreter is the fallback that keeps any reference model file working.
The JAX package runs the same handlers as XLA outside any Pallas kernel, so
the handlers here are plain PyTorch (`torch.matmul`, `F.conv2d`, ...).

Design notes:
  * The value environment holds either tensors (dynamic values) or numpy
    arrays (static values). `Shape` always yields a static numpy array, so
    shape-computation subgraphs (Shape -> Gather -> Concat -> Reshape chains
    from torch traces) stay numpy: under `torch.func.vmap` (the loader
    batches these batch-1 graphs over sessions) a tensor's value cannot be
    read on the host, and nothing here reads one.
  * Dtypes follow `jnp`'s promotion of arrays: two operands of different
    float types meet at the wider one (a bf16 initializer and an f32
    activation give f32, a 0-d array included), and float products
    accumulate in f32 (`preferred_element_type=f32` in the JAX handlers).
    Python scalars stay weak, as in both libraries.
  * Casts follow the JAX package's 32-bit types: a dynamic cast to double
    gives f32 and to int64 gives int32; indices are widened to int64 where
    torch indexes with them, with the same values.
  * The generated function takes the weights as an explicit dict argument,
    so one lowering serves weights on any device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.onnx_model import _NP_DTYPES, OnnxGraph

INT32_MAX = (1 << 31) - 1

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


class OnnxUnsupported(NotImplementedError):
    pass


def _is_static(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _static_np(x, what: str = "value") -> np.ndarray:
    """Require a static (host-known) value, e.g. a reshape target."""
    if _is_static(x):
        return np.asarray(x)
    raise OnnxUnsupported(f"{what} must be static (got a tensor)")


def _device(*vals) -> torch.device:
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _t(x, dev) -> torch.Tensor:
    """x as a tensor: a tensor as it is, a static array on `dev` (f64 as
    f32, as jnp.asarray gives it)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a), device=dev)


def _args(*vals):
    """Tensors of `vals` on one device, promoted to one dtype as jnp promotes
    arrays; Python scalars pass through (weakly typed in both)."""
    dev = _device(*vals)
    ts = [v if isinstance(v, (int, float, bool)) else _t(v, dev) for v in vals]
    dts = [t.dtype for t in ts if isinstance(t, torch.Tensor)]
    dt = dts[0]
    for d in dts[1:]:
        dt = torch.promote_types(dt, d)
    return [t.to(dt) if isinstance(t, torch.Tensor) else t for t in ts]


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Float operands of a product widened to f32 (exact for bf16 and f16):
    the f32 accumulation of `preferred_element_type=jnp.float32`."""
    return x.float() if x.is_floating_point() else x


# -- op handlers -----------------------------------------------------------
# Each handler: (inputs, attrs) -> list of outputs.

_REGISTRY: Dict[str, Callable] = {}


def op(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _elementwise(fn_np, fn_t):
    def handler(inputs, attrs):
        if all(_is_static(v) for v in inputs):
            return [fn_np(*inputs)]
        return [fn_t(*_args(*inputs))]

    return handler


for _name, _np_fn, _t_fn in [
    ("Add", lambda a, b: np.asarray(a) + b, torch.add),
    ("Sub", lambda a, b: np.asarray(a) - b, torch.sub),
    ("Mul", lambda a, b: np.asarray(a) * b, torch.mul),
    ("Pow", np.power, torch.pow),
    ("Sqrt", np.sqrt, torch.sqrt),
    ("Exp", np.exp, torch.exp),
    ("Log", np.log, torch.log),
    ("Neg", np.negative, torch.neg),
    ("Abs", np.abs, torch.abs),
    ("Floor", np.floor, torch.floor),
    ("Ceil", np.ceil, torch.ceil),
    ("Min", np.minimum, torch.minimum),
    ("Max", np.maximum, torch.maximum),
    ("Equal", np.equal, torch.eq),
    ("Greater", np.greater, torch.gt),
    ("GreaterOrEqual", np.greater_equal, torch.ge),
    ("Less", np.less, torch.lt),
    ("LessOrEqual", np.less_equal, torch.le),
    ("And", np.logical_and, torch.logical_and),
    ("Or", np.logical_or, torch.logical_or),
    ("Not", np.logical_not, torch.logical_not),
    ("Sign", np.sign, torch.sign),
    ("Reciprocal", np.reciprocal, torch.reciprocal),
]:
    _REGISTRY[_name] = _elementwise(_np_fn, _t_fn)


@op("Div")
def _div(inputs, attrs):
    a, b = inputs
    if _is_static(a) and _is_static(b):
        return [np.asarray(a) / b if np.asarray(a).dtype.kind == "f" else np.asarray(a) // b]
    # true division where the dividend is a float, else floor division (the
    # JAX handler decides on the dividend's own dtype, before promotion)
    floating = a.is_floating_point() if isinstance(a, torch.Tensor) else np.asarray(a).dtype.kind == "f"
    a, b = _args(a, b)
    return [a / b if floating else torch.div(a, b, rounding_mode="floor")]


def _unary(fn):
    def handler(inputs, attrs):
        return [fn(_t(inputs[0], _device(*inputs)), attrs)]

    return handler


_REGISTRY["Sigmoid"] = _unary(lambda x, a: torch.sigmoid(x))
_REGISTRY["Tanh"] = _unary(lambda x, a: torch.tanh(x))
_REGISTRY["Relu"] = _unary(lambda x, a: torch.relu(x))
_REGISTRY["LeakyRelu"] = _unary(lambda x, a: F.leaky_relu(x, a.get("alpha", 0.01)))
_REGISTRY["Elu"] = _unary(lambda x, a: F.elu(x, a.get("alpha", 1.0)))
# jax.nn.softplus is logaddexp(x, 0) (F.softplus switches to x past 20)
_REGISTRY["Softplus"] = _unary(lambda x, a: torch.logaddexp(x, torch.zeros_like(x)))
_REGISTRY["Erf"] = _unary(lambda x, a: torch.erf(x))
_REGISTRY["Softmax"] = _unary(lambda x, a: torch.softmax(x, dim=a.get("axis", -1)))
_REGISTRY["LogSoftmax"] = _unary(lambda x, a: torch.log_softmax(x, dim=a.get("axis", -1)))


@op("Clip")
def _clip(inputs, attrs):
    x = inputs[0]
    lo = inputs[1] if len(inputs) > 1 and inputs[1] is not None else attrs.get("min")
    hi = inputs[2] if len(inputs) > 2 and inputs[2] is not None else attrs.get("max")
    x = _t(x, _device(*inputs))
    # an attribute bound is a Python float (weakly typed), an input an array
    if lo is not None:
        x = torch.clamp(x, min=lo) if isinstance(lo, float) else torch.maximum(*_args(x, lo))
    if hi is not None:
        x = torch.clamp(x, max=hi) if isinstance(hi, float) else torch.minimum(*_args(x, hi))
    return [x]


@op("MatMul")
def _matmul(inputs, attrs):
    a, b = _args(*inputs)
    return [torch.matmul(_f32(a), _f32(b))]


@op("Gemm")
def _gemm(inputs, attrs):
    a, b = _args(inputs[0], inputs[1])
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    if attrs.get("transA", 0):
        a = a.T
    if attrs.get("transB", 0):
        b = b.T
    y = alpha * torch.matmul(_f32(a), _f32(b))
    if len(inputs) > 2 and inputs[2] is not None:
        y, c = _args(y, inputs[2])
        y = y + beta * c
    return [y]


@op("Conv")
def _conv(inputs, attrs):
    x, w = _args(inputs[0], inputs[1])  # [N, C, *spatial], [O, C/groups, *kernel]
    nspatial = w.ndim - 2
    groups = attrs.get("group", 1)
    strides = list(attrs.get("strides", [1] * nspatial))
    dilations = list(attrs.get("dilations", [1] * nspatial))
    pads = attrs.get("pads", [0] * (2 * nspatial))
    auto_pad = attrs.get("auto_pad", b"NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        # lax's "SAME" padding (the JAX handler's, for either mode)
        pairs = []
        for i in range(nspatial):
            n, k = x.shape[2 + i], w.shape[2 + i]
            out = -(-n // strides[i])
            total = max((out - 1) * strides[i] + (k - 1) * dilations[i] + 1 - n, 0)
            pairs.append((total // 2, total - total // 2))
    else:
        pairs = [(pads[i], pads[i + nspatial]) for i in range(nspatial)]
    x = _f32(x)
    flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}.get(nspatial)
    if conv is None:
        raise OnnxUnsupported(f"Conv over {nspatial} spatial dims")
    y = conv(x, _f32(w), None, strides, 0, dilations, groups)
    if len(inputs) > 2 and inputs[2] is not None:
        y, b = _args(y, inputs[2])
        y = y + b.reshape((1, -1) + (1,) * nspatial)
    return [y]


@op("Reshape")
def _reshape(inputs, attrs):
    x = inputs[0]
    shape = _static_np(inputs[1], "Reshape shape").astype(np.int64).tolist()
    arr = x if isinstance(x, torch.Tensor) else np.asarray(x)
    # ONNX: 0 means "copy dim from input", -1 infers.
    out = []
    for i, d in enumerate(shape):
        if d == 0 and not attrs.get("allowzero", 0):
            out.append(arr.shape[i])
        else:
            out.append(int(d))
    return [arr.reshape(out)]


@op("Transpose")
def _transpose(inputs, attrs):
    x = inputs[0]
    perm = attrs.get("perm")
    if _is_static(x):
        return [np.transpose(np.asarray(x), perm)]
    return [x.permute(perm if perm is not None else list(reversed(range(x.ndim))))]


@op("Squeeze")
def _squeeze(inputs, attrs):
    x = inputs[0]
    axes = attrs.get("axes")
    if axes is None and len(inputs) > 1 and inputs[1] is not None:
        axes = _static_np(inputs[1], "Squeeze axes").tolist()
    if _is_static(x):
        arr = np.asarray(x)
        return [np.squeeze(arr) if axes is None else np.squeeze(arr, axis=tuple(int(a) for a in axes))]
    if axes is None:
        return [x.squeeze()]
    return [x.squeeze(tuple(int(a) for a in axes))]


@op("Unsqueeze")
def _unsqueeze(inputs, attrs):
    x = inputs[0]
    axes = attrs.get("axes")
    if axes is None and len(inputs) > 1:
        axes = _static_np(inputs[1], "Unsqueeze axes").tolist()
    static = _is_static(x)
    arr = np.asarray(x) if static else x
    for a in sorted(int(a) for a in axes):
        a = a if a >= 0 else a + arr.ndim + 1
        arr = np.expand_dims(arr, a) if static else arr.unsqueeze(a)
    return [arr]


@op("Concat")
def _concat(inputs, attrs):
    axis = attrs.get("axis", 0)
    if all(_is_static(v) for v in inputs):
        return [np.concatenate([np.asarray(v) for v in inputs], axis=axis)]
    return [torch.cat(_args(*inputs), dim=axis)]


@op("Split")
def _split(inputs, attrs):
    x = inputs[0]
    axis = attrs.get("axis", 0)
    split = attrs.get("split")
    if split is None and len(inputs) > 1 and inputs[1] is not None:
        split = _static_np(inputs[1], "Split sizes").tolist()
    if split is None:
        raise OnnxUnsupported("Split without sizes")
    if _is_static(x):
        indices = np.cumsum(split)[:-1].tolist()
        return list(np.split(np.asarray(x), indices, axis=axis))
    return list(torch.split(x, [int(s) for s in split], dim=axis))


@op("Slice")
def _slice(inputs, attrs):
    x = inputs[0]
    if "starts" in attrs:  # opset < 10 attribute form
        starts = attrs["starts"]
        ends = attrs["ends"]
        axes = attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = _static_np(inputs[1], "Slice starts").tolist()
        ends = _static_np(inputs[2], "Slice ends").tolist()
        axes = (
            _static_np(inputs[3], "Slice axes").tolist()
            if len(inputs) > 3 and inputs[3] is not None
            else list(range(len(starts)))
        )
        steps = (
            _static_np(inputs[4], "Slice steps").tolist()
            if len(inputs) > 4 and inputs[4] is not None
            else [1] * len(starts)
        )
    static = _is_static(x)
    arr = np.asarray(x) if static else x
    slices = [slice(None)] * arr.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % arr.ndim
        st, en, sp = int(st), int(en), int(sp)
        # Clamp the INT64/INT32 sentinels torch emits for "to the end".
        if en >= INT32_MAX:
            en = None
        elif en <= -INT32_MAX:
            en = None if sp < 0 else 0
        slices[ax] = slice(st, en, sp)
    if static:
        return [arr[tuple(slices)]]
    # torch slices take no negative step: those axes are index-selected
    for ax, s in enumerate(slices):
        start, stop, step = s.indices(arr.shape[ax])
        if step > 0:
            slices[ax] = slice(start, max(start, stop), step)
        else:
            arr = arr.index_select(ax, torch.arange(start, stop, step, device=arr.device))
            slices[ax] = slice(None)
    return [arr[tuple(slices)]]


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """np.take(x, idx, axis) with negative indices counted from the end."""
    axis = axis % x.ndim
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    r = x.movedim(axis, 0)[idx]  # idx.shape + x.shape[:axis] + x.shape[axis+1:]
    k = idx.ndim
    return r.movedim(list(range(k, k + axis)), list(range(axis))) if axis else r


@op("Gather")
def _gather(inputs, attrs):
    x, idx = inputs
    axis = attrs.get("axis", 0)
    if _is_static(x) and _is_static(idx):
        return [np.take(np.asarray(x), np.asarray(idx).astype(np.int64), axis=axis)]
    dev = _device(x, idx)
    return [_take(_t(x, dev), _t(idx, dev), axis)]


@op("GatherElements")
def _gather_elements(inputs, attrs):
    dev = _device(*inputs)
    x, idx = (_t(v, dev) for v in inputs)
    axis = attrs.get("axis", 0) % x.ndim
    idx = idx.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    return [torch.gather(x, axis, idx)]


@op("Shape")
def _shape(inputs, attrs):
    x = inputs[0]
    shape = np.asarray(x).shape if _is_static(x) else tuple(x.shape)
    return [np.array(shape, dtype=np.int64)]


@op("Size")
def _size(inputs, attrs):
    x = inputs[0]
    n = int(np.prod(np.asarray(x).shape if _is_static(x) else tuple(x.shape)))
    return [np.array(n, dtype=np.int64)]


@op("Constant")
def _constant(inputs, attrs):
    if "value" in attrs:
        return [np.asarray(attrs["value"])]
    for k in ("value_float", "value_int"):
        if k in attrs:
            return [np.asarray(attrs[k])]
    if "value_floats" in attrs:
        return [np.asarray(attrs["value_floats"], dtype=np.float32)]
    if "value_ints" in attrs:
        return [np.asarray(attrs["value_ints"], dtype=np.int64)]
    raise OnnxUnsupported("Constant without value")


@op("ConstantOfShape")
def _constant_of_shape(inputs, attrs):
    shape = _static_np(inputs[0], "ConstantOfShape shape").astype(np.int64).tolist()
    value = attrs.get("value")
    if value is None:
        value = np.zeros(1, np.float32)
    value = np.asarray(value).reshape(-1)
    return [np.full(shape, value[0], dtype=value.dtype)]


@op("Expand")
def _expand(inputs, attrs):
    x = inputs[0]
    shape = _static_np(inputs[1], "Expand shape").astype(np.int64).tolist()
    static = _is_static(x)
    arr = np.asarray(x) if static else x
    # ONNX Expand uses bidirectional broadcasting: result dim = max(in, target)
    # with 1s broadcast.
    nd = max(arr.ndim, len(shape))
    in_shape = (1,) * (nd - arr.ndim) + tuple(arr.shape)
    target = [1] * (nd - len(shape)) + [int(s) for s in shape]
    out_shape = tuple(max(a, b) for a, b in zip(in_shape, target))
    if static:
        return [np.broadcast_to(arr.reshape(in_shape), out_shape)]
    return [arr.reshape(in_shape).expand(out_shape)]


@op("Flatten")
def _flatten(inputs, attrs):
    x = inputs[0]
    axis = attrs.get("axis", 1)
    arr = np.asarray(x) if _is_static(x) else x
    lead = int(np.prod(arr.shape[:axis])) if axis > 0 else 1
    return [arr.reshape(lead, -1)]


@op("Cast")
def _cast(inputs, attrs):
    to = attrs.get("to")
    np_dtype = _NP_DTYPES.get(to)
    if np_dtype is None:
        raise OnnxUnsupported(f"Cast to unsupported dtype {to}")
    x = inputs[0]
    if _is_static(x):
        return [np.asarray(x).astype(np_dtype)]
    # the JAX package's 32-bit types: double -> float32, int64 -> int32
    if np_dtype == np.float64:
        np_dtype = np.float32
    if np_dtype == np.int64:
        np_dtype = np.int32
    return [x.to(_TORCH_DTYPES[np.dtype(np_dtype)])]


@op("Identity")
def _identity(inputs, attrs):
    return [inputs[0]]


@op("Dropout")
def _dropout(inputs, attrs):
    # Inference mode: identity (+ optional all-true mask output).
    x = inputs[0]
    shape = np.shape(np.asarray(x)) if _is_static(x) else tuple(x.shape)
    return [x, np.ones(shape, dtype=np.bool_)]


@op("Where")
def _where(inputs, attrs):
    if all(_is_static(v) for v in inputs):
        c, a, b = (np.asarray(v) for v in inputs)
        return [np.where(c, a, b)]
    dev = _device(*inputs)
    c = _t(inputs[0], dev)
    a, b = _args(_t(inputs[1], dev), _t(inputs[2], dev))
    return [torch.where(c if c.dtype == torch.bool else c != 0, a, b)]


@op("Range")
def _range(inputs, attrs):
    start, limit, delta = (_static_np(v, "Range input") for v in inputs)
    return [np.arange(start, limit, delta)]


def _prod(a, axis, keepdims):
    for ax in sorted((x % a.ndim for x in axis), reverse=True):
        a = torch.prod(a, dim=ax, keepdim=keepdims)
    return a


def _reduce(fn_np, fn_t):
    def handler(inputs, attrs):
        x = inputs[0]
        axes = attrs.get("axes")
        if axes is None and len(inputs) > 1 and inputs[1] is not None:
            axes = _static_np(inputs[1], "Reduce axes").tolist()
        keepdims = bool(attrs.get("keepdims", 1))
        if _is_static(x):
            axis = tuple(int(a) for a in axes) if axes is not None else None
            return [fn_np(np.asarray(x), axis=axis, keepdims=keepdims)]
        axis = tuple(int(a) for a in axes) if axes is not None else tuple(range(x.ndim))
        return [fn_t(x, axis, keepdims)]

    return handler


_REGISTRY["ReduceMean"] = _reduce(
    np.mean, lambda a, axis, k: torch.mean(a if a.is_floating_point() else a.float(), dim=axis, keepdim=k))
_REGISTRY["ReduceSum"] = _reduce(np.sum, lambda a, axis, k: torch.sum(a, dim=axis, keepdim=k))
_REGISTRY["ReduceMax"] = _reduce(np.max, lambda a, axis, k: torch.amax(a, dim=axis, keepdim=k))
_REGISTRY["ReduceMin"] = _reduce(np.min, lambda a, axis, k: torch.amin(a, dim=axis, keepdim=k))
_REGISTRY["ReduceProd"] = _reduce(np.prod, _prod)
_REGISTRY["ReduceL2"] = _reduce(
    lambda a, axis, keepdims: np.sqrt(np.sum(a * a, axis=axis, keepdims=keepdims)),
    lambda a, axis, k: torch.sqrt(torch.sum(a * a, dim=axis, keepdim=k)),
)


@op("ArgMax")
def _argmax(inputs, attrs):
    x = _t(inputs[0], _device(*inputs))
    axis = attrs.get("axis", 0)
    keepdims = bool(attrs.get("keepdims", 1))
    return [torch.argmax(x, dim=axis, keepdim=keepdims).to(torch.int32)]


def _pad_index(n: int, lo: int, hi: int, mode: str, dev) -> torch.Tensor:
    """Source index of every padded position along one axis (np.pad's
    "reflect" and "edge")."""
    i = torch.arange(-lo, n + hi, device=dev)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i < n, i, period - i)


@op("Pad")
def _pad(inputs, attrs):
    x = inputs[0]
    if "pads" in attrs:
        pads = attrs["pads"]
    else:
        pads = _static_np(inputs[1], "Pad pads").tolist()
    value = 0.0
    if len(inputs) > 2 and inputs[2] is not None:
        value = float(_static_np(inputs[2], "Pad value"))
    mode = attrs.get("mode", b"constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    static = _is_static(x)
    arr = np.asarray(x) if static else x
    nd = arr.ndim
    pad_width = [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
    if static:
        if mode == "constant":
            return [np.pad(arr, pad_width, mode="constant", constant_values=value)]
        return [np.pad(arr, pad_width, mode={"reflect": "reflect", "edge": "edge"}[mode])]
    if mode == "constant":
        return [F.pad(arr, [p for lo_hi in reversed(pad_width) for p in lo_hi], value=value)]
    mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for ax, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            arr = arr.index_select(ax, _pad_index(arr.shape[ax], lo, hi, mode, arr.device))
    return [arr]


@op("LayerNormalization")
def _layer_norm(inputs, attrs):
    dev = _device(*inputs)
    x = _t(inputs[0], dev)
    scale = _t(inputs[1], dev)
    bias = _t(inputs[2], dev) if len(inputs) > 2 and inputs[2] is not None else None
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-5)
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=axis, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        y = y + bias
    return [y]


@op("BatchNormalization")
def _batch_norm(inputs, attrs):
    dev = _device(*inputs)
    x, scale, bias, mean, var = (_t(v, dev) for v in inputs[:5])
    eps = attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    return [y * scale.reshape(shape) + bias.reshape(shape)]


@op("LSTM")
def _lstm(inputs, attrs):
    """ONNX LSTM, forward direction, gate order iofc (ONNX spec §LSTM): a
    Python loop over time (the JAX handler's lax.scan) with the gate
    products in f32."""
    dev = _device(*inputs)
    opt = lambda i: _t(inputs[i], dev) if len(inputs) > i and inputs[i] is not None else None  # noqa: E731
    X, W, R = (_t(v, dev) for v in inputs[:3])  # [T, N, I], [1, 4H, I], [1, 4H, H]
    B = opt(3)
    # inputs[4] = sequence_lens (unsupported; assume full length)
    h0, c0 = opt(5), opt(6)
    if len(inputs) > 7 and inputs[7] is not None:
        raise OnnxUnsupported("LSTM peepholes not supported")

    direction = attrs.get("direction", b"forward")
    if isinstance(direction, bytes):
        direction = direction.decode()
    if direction != "forward":
        raise OnnxUnsupported(f"LSTM direction {direction}")
    hidden = int(attrs["hidden_size"])

    T, N, _ = X.shape
    Wt = _f32(W[0].T)  # [I, 4H]
    Rt = _f32(R[0].T)  # [H, 4H]
    if B is not None:
        bias = B[0, : 4 * hidden] + B[0, 4 * hidden :]
    else:
        bias = torch.zeros(4 * hidden, dtype=X.dtype, device=dev)
    h = h0[0] if h0 is not None else torch.zeros((N, hidden), dtype=X.dtype, device=dev)
    c = c0[0] if c0 is not None else torch.zeros((N, hidden), dtype=X.dtype, device=dev)

    ys = []
    for t in range(T):
        gates = torch.matmul(_f32(X[t]), Wt) + torch.matmul(_f32(h), Rt) + bias
        i, o, f, g = torch.split(gates, hidden, dim=-1)  # ONNX order: i o f c
        i = torch.sigmoid(i)
        o = torch.sigmoid(o)
        f = torch.sigmoid(f)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    Y = torch.stack(ys)[:, None]  # [T, 1, N, H]
    return [Y, h[None], c[None]]


# -- graph executor --------------------------------------------------------


def lower_graph(graph: OnnxGraph) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """Return (fn, weights): fn(weights, *inputs) -> tuple(outputs).

    `weights` holds the initializers as CPU tensors (copies: the parsed
    `raw_data` views are read-only); move them to the device that serves
    them and pass them in. Small integer initializers (Reshape/Slice shape
    tensors etc.) stay numpy constants in the closure instead, so the shape
    arithmetic that reads them stays on the host. Every output is a tensor,
    on the device of the inputs (a static output too), so `fn` vmaps."""
    weights = {}
    static_consts = {}
    for k, v in graph.initializers.items():
        if v.dtype.kind in "iu" and v.size <= 64:
            static_consts[k] = v
        else:
            weights[k] = torch.from_numpy(np.array(v, np.float32 if v.dtype == np.float64 else v.dtype))

    def fn(params: Dict[str, torch.Tensor], *args):
        if len(args) != len(graph.inputs):
            raise ValueError(
                f"graph {graph.name!r} expects {len(graph.inputs)} inputs "
                f"({graph.inputs}), got {len(args)}"
            )
        env: Dict[str, object] = {}
        env.update(static_consts)
        env.update(params)
        for name, val in zip(graph.inputs, args):
            env[name] = val

        for node in graph.nodes:
            handler = _REGISTRY.get(node.op_type)
            if handler is None:
                raise OnnxUnsupported(f"ONNX op {node.op_type} not supported")
            ins = [env[n] if n else None for n in node.inputs]
            try:
                outs = handler(ins, node.attrs)
            except OnnxUnsupported:
                raise
            except Exception as e:
                raise RuntimeError(
                    f"error executing {node.op_type} node {node.name!r}: {e}"
                ) from e
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val

        dev = _device(*args)
        return tuple(_t(env[n], dev) for n in graph.outputs)

    return fn, weights


def supported_ops() -> List[str]:
    return sorted(_REGISTRY.keys())
