"""Port parity: ONNX-form `.april` models, from the protobuf reader through
the verified weight extraction and the ONNX-to-torch interpreter.

* Writer: the port's `build_transducer_graphs` and `save_april(form="onnx")`
  write the JAX package's bytes for the same params.
* Parser: `parse_model` gives the JAX parser's nodes, attributes, I/O
  shapes and bit-equal initializers, on the traced icefall-style graphs
  (`april_asr_tpu.testing.export_onnx_networks`, the form real files hold),
  on `onnx_build`'s graphs and on a traced `nn.LSTM` (the LSTM op).
* Extraction: `extract_transducer` gives JAX's dims and bit-equal params on
  both encoder forms (unrolled and LSTM op), and raises ExtractionError
  where JAX does.
* Lowering: `supported_ops()` is JAX's list; every handler agrees with
  JAX's on random inputs (one case per op, a few more for ops with several
  paths); the three graphs agree at f32 within atol 1e-5; a vmapped batch of
  S = 3 equals three batch-1 calls.
* Loader: `kind` and dims as JAX's `load_model` gives them with
  prefer_native True and False, and where extraction or verification fails;
  the wrong network count raises ValueError; the interpreter's batched
  functions agree with JAX's at the tolerance of the lowering.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.io import onnx_build as j_build
from april_asr_tpu.io import onnx_model as j_onnx
from april_asr_tpu.models import extract as j_extract
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.export import make_model_parameters as j_mmp
from april_asr_tpu.models.export import save_april as j_save_april
from april_asr_tpu.models.loader import load_model as j_load_model
from april_asr_tpu.ops import onnx2jax as j_o2j
from april_asr_tpu.testing import (
    FixtureConfig,
    build_torch_modules,
    default_tokens,
    export_onnx_networks,
    write_test_april,
)
from april_asr_tpu_torch.io import onnx_build as t_build
from april_asr_tpu_torch.io import onnx_model as t_onnx
from april_asr_tpu_torch.io.container import AprilContainer, read_container, write_container
from april_asr_tpu_torch.models import extract as t_extract
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.models.export import make_model_parameters, save_april
from april_asr_tpu_torch.models.loader import load_model
from april_asr_tpu_torch.ops import onnx2torch as t_o2t

CFG = FixtureConfig()
DIMS_KW = dict(d_model=64, hidden=96, ffn=128, joiner_dim=64, vocab=40, layers=2,
               decoder_groups=16, conv_channels=(4, 8, 8))
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced():
    """The icefall-style torch modules traced to ONNX (real files' form)."""
    return export_onnx_networks(CFG, build_torch_modules(CFG))


@pytest.fixture(scope="module")
def native_params():
    dims = JM.TransducerDims(**DIMS_KW)
    p = {k: np.asarray(v) for k, v in JM.init_transducer_params(jax.random.PRNGKey(3), dims).items()}
    return dims, p


@pytest.fixture(scope="module")
def built(native_params):
    """onnx_build's graphs (the exporters' form) of random native params."""
    dims, p = native_params
    return j_build.build_transducer_graphs(dims, p)


@pytest.fixture(scope="module")
def lstm_op_bytes():
    """A traced nn.LSTM: the ONNX LSTM op (test_onnx2jax.py:104)."""
    torch.manual_seed(0)
    lstm = torch.nn.LSTM(8, 12).eval()
    x, h0, c0 = torch.randn(5, 2, 8), torch.randn(1, 2, 12), torch.randn(1, 2, 12)
    b = io.BytesIO()
    torch.onnx.export(lstm, (x, (h0, c0)), b, opset_version=11, dynamo=False,
                      input_names=["x", "h0", "c0"], output_names=["y", "hn", "cn"])
    return b.getvalue(), (x.numpy(), h0.numpy(), c0.numpy())


# -- writer ---------------------------------------------------------------------


def test_writer_bytes_equal_jax(native_params, built):
    dims, p = native_params
    t_dims = TM.TransducerDims(**DIMS_KW)
    assert t_build.build_transducer_graphs(t_dims, p) == built


def test_save_april_onnx_file_equal_jax(native_params, tmp_path):
    dims, p = native_params
    t_dims = TM.TransducerDims(**DIMS_KW)
    kw = dict(name="onnx-io", description="same bytes", form="onnx")
    j_save_april(tmp_path / "j.april", dims, p, j_mmp(dims, default_tokens(dims.vocab)), **kw)
    save_april(tmp_path / "t.april", t_dims, {k: torch.from_numpy(v) for k, v in p.items()},
               make_model_parameters(t_dims, default_tokens(dims.vocab)), **kw)
    assert (tmp_path / "t.april").read_bytes() == (tmp_path / "j.april").read_bytes()
    assert read_container(tmp_path / "t.april").model_type == 1


def test_save_april_unknown_form(native_params, tmp_path):
    dims, p = native_params
    t_dims = TM.TransducerDims(**DIMS_KW)
    with pytest.raises(ValueError, match="unknown export form"):
        save_april(tmp_path / "x.april", t_dims, p,
                   make_model_parameters(t_dims, default_tokens(dims.vocab)), form="tflite")


# -- parser ---------------------------------------------------------------------


def _same_attr(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, j_onnx.OnnxGraph):
        return True
    return type(a) is type(b) and a == b


def _same_graph(t, j):
    assert (t.name, t.inputs, t.outputs) == (j.name, j.inputs, j.outputs)
    assert t.input_shapes == j.input_shapes and t.output_shapes == j.output_shapes
    assert t.input_dtypes == j.input_dtypes
    assert [(n.op_type, n.inputs, n.outputs, n.name) for n in t.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.name) for n in j.nodes]
    for tn, jn in zip(t.nodes, j.nodes):
        assert tn.attrs.keys() == jn.attrs.keys(), tn.name
        for k in tn.attrs:
            assert _same_attr(tn.attrs[k], jn.attrs[k]), (tn.name, k)
    assert t.initializers.keys() == j.initializers.keys()
    for k, v in t.initializers.items():
        w = j.initializers[k]
        assert v.dtype == w.dtype and v.shape == w.shape, k
        assert v.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("which", ["traced", "built", "lstm_op"])
def test_parser_matches_jax(which, traced, built, lstm_op_bytes):
    nets = {"traced": traced, "built": built, "lstm_op": (lstm_op_bytes[0],)}[which]
    for data in nets:
        t, j = t_onnx.parse_model(data), j_onnx.parse_model(data)
        assert (t.ir_version, t.opset) == (j.ir_version, j.opset)
        _same_graph(t.graph, j.graph)
    if which == "lstm_op":
        assert any(n.op_type == "LSTM" for n in t.graph.nodes)


def test_parser_keeps_raw_data_views(built):
    """raw_data initializers are np.frombuffer views of the model bytes."""
    g = t_onnx.parse_model(built[0]).graph
    w = g.initializers["l0_w_ih"]
    assert not w.flags.owndata and not w.flags.writeable


# -- extraction -------------------------------------------------------------------


def _lstm_op_encoder(p, L, d, H, dims) -> bytes:
    """An encoder of ONNX LSTM nodes (the form `_extract_encoder_lstm_op`
    reads), d == H: convs, the embed, per layer LSTM (W, R, B in iofc order)
    then w_hr, the FFN and the norm, then enc_proj."""
    g = t_build.GraphBuilder("encoder")
    x = g.input("x", (1, dims.segment_size, dims.mel))
    y = g.node("Unsqueeze", [x], axes=[1])
    for i, (stride, pad) in enumerate(((1, 1), (2, 0), (2, 0)), 1):
        y = g.node("Conv", [y, g.init(f"conv{i}_w", p[f"conv{i}_w"]), g.init(f"conv{i}_b", p[f"conv{i}_b"])],
                   strides=[stride, stride], pads=[pad] * 4, kernel_shape=[3, 3])
    y = g.node("Reshape", [y, g.init("r", np.array([1, -1], np.int64))])
    y = g.matmul_bias(y, p["embed_out_w"], p["embed_out_b"], "embed_out")

    def ifgo_to_iofc(w4h):
        i, f, gg, o = np.split(w4h, 4, axis=0)
        return np.concatenate([i, o, f, gg], axis=0)

    for l in range(L):
        W = ifgo_to_iofc(p["w_ih_t"][l].T)[None]
        R = ifgo_to_iofc(p["w_hh_t"][l].T)[None]
        B = np.concatenate([ifgo_to_iofc(p["bias"][l][:, None])[:, 0], np.zeros(4 * H, np.float32)])[None]
        seq = g.node("Unsqueeze", [y], axes=[0])
        out = g.node("LSTM", [seq, g.init(f"l{l}_W", W), g.init(f"l{l}_R", R), g.init(f"l{l}_B", B)],
                     [g.fresh("Y"), g.fresh("Yh"), g.fresh("Yc")], hidden_size=H)[1]
        hc = g.node("Squeeze", [out], axes=[0])
        y = g.node("Add", [y, g.node("MatMul", [hc, g.init(f"l{l}_w_hr", p["w_hr_t"][l])])])
        ff = g.matmul_bias(g.double_swish(g.matmul_bias(y, p["ff1_t"][l], p["ff1_b"][l], f"l{l}_ff1")),
                           p["ff2_t"][l], p["ff2_b"][l], f"l{l}_ff2")
        y = g.node("Add", [y, ff])
        eps = g.init(f"l{l}_eps", np.float32(p["norm_eps"][l]).reshape(()))
        y = g.node("Add", [g.node("Mul", [y, y]), eps])
    out = g.matmul_bias(y, p["enc_proj_t"], p["enc_proj_b"], "enc_proj")
    g.node("Identity", [out], ["encoder_out"])
    g.output("encoder_out", (1, dims.joiner_dim))
    return g.build()


@pytest.fixture(scope="module")
def lstm_op_model():
    dims = JM.TransducerDims(**dict(DIMS_KW, hidden=DIMS_KW["d_model"]))
    p = {k: np.asarray(v) for k, v in JM.init_transducer_params(jax.random.PRNGKey(4), dims).items()}
    _, dec, joi = j_build.build_transducer_graphs(dims, p)
    return dims, p, (_lstm_op_encoder(p, dims.layers, dims.d_model, dims.hidden, dims), dec, joi)


def _extract_both(nets, dims):
    kw = dict(segment_size=dims.segment_size, segment_step=dims.segment_step, mel=dims.mel)
    jg = [j_onnx.parse_model(b).graph for b in nets]
    tg = [t_onnx.parse_model(b).graph for b in nets]
    return j_extract.extract_transducer(*jg, **kw), t_extract.extract_transducer(*tg, **kw)


def _same_extraction(j, t):
    (jd, jp), (td, tp) = j, t
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert tp.keys() == jp.keys()
    for k in tp:
        assert tp[k].dtype == jp[k].dtype and tp[k].shape == jp[k].shape, k
        assert tp[k].tobytes() == jp[k].tobytes(), k


@pytest.mark.parametrize("form", ["traced", "built", "lstm_op"])
def test_extraction_matches_jax(form, traced, built, native_params, lstm_op_model):
    if form == "lstm_op":
        dims, p, nets = lstm_op_model
    else:
        dims = JM.TransducerDims(**DIMS_KW) if form == "built" else CFG
        nets = built if form == "built" else traced
    j, t = _extract_both(nets, dims)
    _same_extraction(j, t)
    if form != "traced":
        # the weights are the params written, bit for bit
        p = native_params[1] if form == "built" else p
        for k, v in t[1].items():
            assert v.tobytes() == np.asarray(p[k], np.float32).tobytes(), k
    if form == "lstm_op":
        assert t[0].hidden == dims.hidden and t[0].layers == dims.layers


def _drop_nodes(data: bytes, op: str, keep: int) -> bytes:
    """The model with all but the first `keep` nodes of type `op` removed
    (their outputs aliased through Identity so the graph stays whole)."""
    from april_asr_tpu_torch.io.protowire import MessageWriter, decode_message

    m = decode_message(data)
    g = decode_message(m[7][0][1])
    seen = 0
    out = MessageWriter()
    for field, entries in g.items():
        for wire, val in entries:
            if field == 1:
                n = decode_message(val)
                if n[4][0][1].decode() == op:
                    seen += 1
                    if seen > keep:
                        ident = MessageWriter()
                        ident.bytes_field(1, n[1][0][1])
                        for _, o in n.get(2, []):
                            ident.bytes_field(2, o)
                        ident.string(4, "Identity")
                        out.message(1, ident)
                        continue
            out.bytes_field(field, val) if wire == 2 else out.varint(field, val)
    top = MessageWriter()
    for field, entries in m.items():
        for wire, val in entries:
            if field == 7:
                top.message(7, out)
            else:
                top.bytes_field(field, val) if wire == 2 else top.varint(field, val)
    return bytes(top)


REFUSED = {
    # graph, op whose nodes past the first `keep` are dropped, keep
    "two_convs": (0, "Conv", 2),
    "no_dec_conv": (1, "Conv", 0),
    "no_joiner_bias": (2, "Add", 0),
    "no_joiner_tanh": (2, "Tanh", 0),
    "no_dec_relu": (1, "Relu", 0),
    "short_stack": (0, "MatMul", 6),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_extraction_refuses_as_jax(case, built):
    k, op, keep = REFUSED[case]
    nets = list(built)
    nets[k] = _drop_nodes(nets[k], op, keep)
    dims = JM.TransducerDims(**DIMS_KW)
    with pytest.raises(j_extract.ExtractionError) as je:
        _extract_both(nets, dims)
    kw = dict(segment_size=dims.segment_size, segment_step=dims.segment_step, mel=dims.mel)
    with pytest.raises(t_extract.ExtractionError) as te:
        t_extract.extract_transducer(*[t_onnx.parse_model(b).graph for b in nets], **kw)
    assert str(te.value) == str(je.value)


# -- lowering ---------------------------------------------------------------------


def test_supported_ops_equal_jax():
    assert t_o2t.supported_ops() == j_o2j.supported_ops()


I64 = np.iinfo(np.int64).max


def _r(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _cases():
    """{case: (op, inputs [(kind, array)], attrs)}; kind "d" a tensor on both
    sides, "s" a static numpy value, None an absent optional input."""
    rng = np.random.default_rng(0)
    d = lambda a: ("d", a)  # noqa: E731
    s = lambda a: ("s", np.asarray(a))  # noqa: E731
    c = {}
    for name in ("Add", "Sub", "Mul", "Div", "Min", "Max"):
        c[name] = (name, [d(_r(rng, 3, 4)), d(_r(rng, 4, lo=0.5, hi=2.0))], {})
    c["Div-int"] = ("Div", [d(np.array([7, -7, 9], np.int32)), s(np.array([2, 2, -4], np.int32))], {})
    c["Pow"] = ("Pow", [d(_r(rng, 3, 4, lo=0.1, hi=2.0)), s(np.float32(-0.5))], {})
    for name, lo in (("Sqrt", 0.1), ("Exp", -2.0), ("Log", 0.1), ("Neg", -2.0), ("Abs", -2.0),
                     ("Floor", -3.0), ("Ceil", -3.0), ("Sign", -2.0), ("Reciprocal", 0.5),
                     ("Sigmoid", -3.0), ("Tanh", -3.0), ("Relu", -1.0), ("Erf", -2.0)):
        c[name] = (name, [d(_r(rng, 3, 5, lo=lo, hi=3.0))], {})
    ints = np.round(_r(rng, 4, 5, lo=-2, hi=2))
    for name in ("Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual"):
        c[name] = (name, [d(ints), d(np.round(_r(rng, 5, lo=-2, hi=2)))], {})
    bools = rng.random((3, 4)) > 0.5
    for name in ("And", "Or"):
        c[name] = (name, [d(bools), d(rng.random((3, 4)) > 0.5)], {})
    c["Not"] = ("Not", [d(bools)], {})
    c["LeakyRelu"] = ("LeakyRelu", [d(_r(rng, 3, 5))], {"alpha": 0.2})
    c["Elu"] = ("Elu", [d(_r(rng, 3, 5, lo=-3))], {"alpha": 0.7})
    c["Softplus"] = ("Softplus", [d(_r(rng, 3, 5, lo=-30, hi=30))], {})
    c["Softmax"] = ("Softmax", [d(_r(rng, 2, 3, 5))], {"axis": 1})
    c["LogSoftmax"] = ("LogSoftmax", [d(_r(rng, 2, 3, 5))], {"axis": -1})
    c["Clip"] = ("Clip", [d(_r(rng, 4, 5)), s(np.float32(-0.3)), s(np.float32(0.4))], {})
    c["MatMul"] = ("MatMul", [d(_r(rng, 2, 3, 4)), d(_r(rng, 4, 5))], {})
    c["Gemm"] = ("Gemm", [d(_r(rng, 3, 4)), d(_r(rng, 5, 4)), d(_r(rng, 5))],
                 {"transB": 1, "alpha": 0.5, "beta": 2.0})
    c["Conv"] = ("Conv", [d(_r(rng, 1, 2, 7, 6)), d(_r(rng, 4, 2, 3, 3)), d(_r(rng, 4))],
                 {"strides": [2, 1], "pads": [1, 0, 0, 1], "kernel_shape": [3, 3]})
    c["Conv-grouped-1d"] = ("Conv", [d(_r(rng, 1, 8, 5)), d(_r(rng, 8, 2, 2))],
                            {"group": 4, "dilations": [2], "kernel_shape": [2]})
    c["Conv-same"] = ("Conv", [d(_r(rng, 1, 1, 6, 5)), d(_r(rng, 2, 1, 3, 3))],
                      {"auto_pad": b"SAME_UPPER", "strides": [2, 2]})
    c["Reshape"] = ("Reshape", [d(_r(rng, 2, 3, 4)), s(np.array([0, -1], np.int64))], {})
    c["Transpose"] = ("Transpose", [d(_r(rng, 2, 3, 4))], {"perm": [2, 0, 1]})
    c["Squeeze"] = ("Squeeze", [d(_r(rng, 1, 3, 1, 4))], {"axes": [0, 2]})
    c["Unsqueeze"] = ("Unsqueeze", [d(_r(rng, 3, 4))], {"axes": [0, -1]})
    c["Concat"] = ("Concat", [d(_r(rng, 2, 3)), s(_r(rng, 2, 1)), d(_r(rng, 2, 2))], {"axis": 1})
    c["Concat-static"] = ("Concat", [s(np.array([1], np.int64)), s(np.array([-1, 4], np.int64))],
                          {"axis": 0})
    c["Split"] = ("Split", [d(_r(rng, 2, 9))], {"axis": 1, "split": [2, 3, 4]})
    c["Slice"] = ("Slice", [d(_r(rng, 5, 6)), s(np.array([1, -1])), s(np.array([I64, -I64])),
                            s(np.array([0, 1])), s(np.array([2, -1]))], {})
    c["Slice-attrs"] = ("Slice", [d(_r(rng, 5, 6))], {"starts": [1], "ends": [4], "axes": [1]})
    c["Gather"] = ("Gather", [d(_r(rng, 2, 5, 3)), d(np.array([[0, 4], [1, -2]], np.int64))],
                   {"axis": 1})
    c["Gather-static"] = ("Gather", [s(np.array([2, 3, 4], np.int64)), s(np.array(1, np.int64))],
                          {"axis": 0})
    c["GatherElements"] = ("GatherElements", [d(_r(rng, 3, 4)), d(rng.integers(0, 4, (3, 2)))],
                           {"axis": 1})
    c["Shape"] = ("Shape", [d(_r(rng, 2, 3))], {})
    c["Size"] = ("Size", [d(_r(rng, 2, 3))], {})
    c["Constant"] = ("Constant", [], {"value": _r(rng, 2, 2)})
    c["ConstantOfShape"] = ("ConstantOfShape", [s(np.array([2, 3], np.int64))],
                            {"value": np.array([1.5], np.float32)})
    c["Expand"] = ("Expand", [d(_r(rng, 3, 1)), s(np.array([2, 3, 4], np.int64))], {})
    c["Flatten"] = ("Flatten", [d(_r(rng, 2, 3, 4))], {"axis": 2})
    c["Cast"] = ("Cast", [d(_r(rng, 3, 4, lo=-5, hi=5))], {"to": 7})
    c["Identity"] = ("Identity", [d(_r(rng, 3))], {})
    c["Dropout"] = ("Dropout", [d(_r(rng, 3, 2))], {})
    c["Where"] = ("Where", [d(rng.random((3, 4)) > 0.5), d(_r(rng, 3, 4)), s(np.float32(2.0))], {})
    c["Range"] = ("Range", [s(np.int64(1)), s(np.int64(9)), s(np.int64(3))], {})
    for name in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd", "ReduceL2"):
        c[name] = (name, [d(_r(rng, 2, 3, 4, lo=0.5, hi=1.5))], {"axes": [1, 2], "keepdims": 0})
    c["ReduceMean-keep"] = ("ReduceMean", [d(_r(rng, 2, 3, 4))], {"axes": [-1], "keepdims": 1})
    c["ArgMax"] = ("ArgMax", [d(_r(rng, 3, 5))], {"axis": 1, "keepdims": 1})
    c["Pad"] = ("Pad", [d(_r(rng, 2, 3)), s(np.array([1, 2, 0, 1], np.int64)), s(np.float32(0.5))], {})
    c["Pad-reflect"] = ("Pad", [d(_r(rng, 3, 4))], {"pads": [1, 2, 2, 1], "mode": b"reflect"})
    c["Pad-edge"] = ("Pad", [d(_r(rng, 3, 4))], {"pads": [0, 3, 2, 0], "mode": b"edge"})
    c["LayerNormalization"] = ("LayerNormalization", [d(_r(rng, 2, 5)), d(_r(rng, 5)), d(_r(rng, 5))],
                               {"epsilon": 1e-5})
    c["BatchNormalization"] = ("BatchNormalization",
                               [d(_r(rng, 2, 3, 4)), d(_r(rng, 3)), d(_r(rng, 3)), d(_r(rng, 3)),
                                d(_r(rng, 3, lo=0.5, hi=2.0))], {"epsilon": 1e-5})
    c["LSTM"] = ("LSTM", [d(_r(rng, 4, 2, 3)), d(_r(rng, 1, 16, 3)), d(_r(rng, 1, 16, 4)),
                          d(_r(rng, 1, 32)), None, d(_r(rng, 1, 2, 4)), d(_r(rng, 1, 2, 4))],
                 {"hidden_size": 4})
    return c


CASES = _cases()


def test_every_op_has_a_case():
    assert {op for op, _, _ in CASES.values()} == set(t_o2t.supported_ops())


@pytest.mark.parametrize("case", sorted(CASES))
def test_handler_matches_jax(case):
    op, ins, attrs = CASES[case]
    j_ins = [None if v is None else (jnp.asarray(v[1]) if v[0] == "d" else v[1]) for v in ins]
    t_ins = [None if v is None else (torch.from_numpy(np.array(v[1])) if v[0] == "d" else v[1])
             for v in ins]
    j_out = j_o2j._REGISTRY[op](j_ins, attrs)
    t_out = t_o2t._REGISTRY[op](t_ins, attrs)
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        assert isinstance(t, torch.Tensor) != j_o2j._is_static(j), "static/dynamic differs"
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        j = np.asarray(j)
        assert t.shape == j.shape
        assert t.dtype.kind == j.dtype.kind, (t.dtype, j.dtype)
        if j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, atol=ATOL, rtol=1e-5)
        else:
            np.testing.assert_array_equal(t, j)


def test_mixed_precision_promotes_as_jnp():
    """A bf16 initializer meets an f32 activation: f32, as jnp promotes; a
    bf16 product accumulates in f32."""
    x = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(8, 4)).astype(np.float32)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    for op, ins_t, ins_j in (("MatMul", [torch.from_numpy(x), wt], [jnp.asarray(x), wj]),
                             ("Add", [torch.from_numpy(x[:, :4]), wt[0]], [jnp.asarray(x[:, :4]), wj[0]]),
                             ("Mul", [wt, np.float32(0.5)], [wj, np.float32(0.5)])):
        (t,) = t_o2t._REGISTRY[op](ins_t, {})
        (j,) = j_o2j._REGISTRY[op](ins_j, {})
        assert str(t.dtype).split(".")[-1] == str(j.dtype), op
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=ATOL, rtol=1e-5)


def _graph_inputs(rng, S=None):
    lead = () if S is None else (S,)
    x = rng.normal(size=lead + (1, CFG.segment_size, CFG.mel)).astype(np.float32)
    h = (rng.normal(size=lead + (CFG.layers, 1, CFG.d_model)) * 0.1).astype(np.float32)
    c = (rng.normal(size=lead + (CFG.layers, 1, CFG.hidden)) * 0.1).astype(np.float32)
    return x, h, c


def test_graphs_match_jax(traced):
    rng = np.random.default_rng(5)
    enc, dec, joi = (t_onnx.parse_model(b).graph for b in traced)
    jenc, jdec, jjoi = (j_onnx.parse_model(b).graph for b in traced)
    tf, tw = t_o2t.lower_graph(enc)
    jf, jw = j_o2j.lower_graph(jenc)
    assert tw.keys() == jw.keys()
    ins = _graph_inputs(rng)
    with torch.no_grad():
        t_out = tf(tw, *(torch.from_numpy(a) for a in ins))
    j_out = jax.jit(jf)(jw, *ins)
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    ctx = np.array([[3, 7]], np.int64)
    tf, tw = t_o2t.lower_graph(dec)
    jf, jw = j_o2j.lower_graph(jdec)
    (td,) = tf(tw, torch.from_numpy(ctx))
    (jd,) = jax.jit(jf)(jw, ctx)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    tf, tw = t_o2t.lower_graph(joi)
    jf, jw = j_o2j.lower_graph(jjoi)
    (tl,) = tf(tw, t_out[0], td)
    (jl,) = jax.jit(jf)(jw, np.asarray(j_out[0]), np.asarray(jd))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_lstm_op_graph_matches_jax(lstm_op_bytes):
    data, ins = lstm_op_bytes
    tf, tw = t_o2t.lower_graph(t_onnx.parse_model(data).graph)
    jf, jw = j_o2j.lower_graph(j_onnx.parse_model(data).graph)
    t_out = tf(tw, *(torch.from_numpy(a) for a in ins))
    j_out = jax.jit(jf)(jw, *ins)
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_vmapped_batch_equals_single_calls(traced):
    fn, w = t_o2t.lower_graph(t_onnx.parse_model(traced[0]).graph)
    x, h, c = (torch.from_numpy(a) for a in _graph_inputs(np.random.default_rng(6), S=3))
    with torch.no_grad():
        be, bh, bc = torch.func.vmap(fn, in_dims=(None, 0, 0, 0))(w, x, h, c)
        for i in range(3):
            ei, hi, ci = fn(w, x[i], h[i], c[i])
            for b, one in ((be, ei), (bh, hi), (bc, ci)):
                np.testing.assert_allclose(b[i].numpy(), one.numpy(), atol=ATOL)


# -- loader -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced_april(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("onnx") / "traced.april")
    write_test_april(path, CFG)
    return path


@pytest.fixture(scope="module")
def built_april(tmp_path_factory, native_params):
    dims, p = native_params
    path = str(tmp_path_factory.mktemp("onnx") / "built.april")
    j_save_april(path, dims, p, j_mmp(dims, default_tokens(dims.vocab)), form="onnx")
    return path


def _rewrite(path, out, k, old: bytes, new: bytes):
    """A copy of the model with one network's bytes `old` replaced by `new`
    (same length: op-type strings, so the protobuf stays whole)."""
    c = read_container(path)
    nets = list(c.networks)
    nets[k] = nets[k].replace(old, new)
    write_container(out, dataclasses.replace(c, networks=nets))
    return str(out)


@pytest.mark.parametrize("which", ["traced", "built", "bad_verify", "bad_extract"])
@pytest.mark.parametrize("prefer_native", [True, False])
def test_loader_kind_and_dims_match_jax(which, prefer_native, traced_april, built_april, tmp_path):
    path = {"traced": traced_april, "built": built_april,
            # extraction passes, the activations differ: verification fails
            "bad_verify": lambda: _rewrite(built_april, tmp_path / "v.april", 0, b"Tanh", b"Relu"),
            # the decoder lacks its relu: extraction refuses
            "bad_extract": lambda: _rewrite(built_april, tmp_path / "e.april", 1, b"Relu", b"Tanh"),
            }[which]
    path = path() if callable(path) else path
    rt = load_model(path, prefer_native=prefer_native, device="cpu")
    jrt = j_load_model(path, prefer_native=prefer_native)
    assert rt.kind == jrt.kind
    assert rt.kind == ("native" if prefer_native and which in ("traced", "built") else "interp")
    assert dataclasses.asdict(rt.dims) == dataclasses.asdict(jrt.dims)
    assert rt.state_shapes == jrt.state_shapes
    if rt.kind == "native":
        for k, v in jrt.weights.items():
            if not JM.is_derived(k):
                np.testing.assert_array_equal(rt.weights[k].numpy(), np.asarray(v), err_msg=k)
        assert set(rt.load_seconds) == {"read", "parse", "extract", "upload", "verify"}
        assert max(rt.verify_max_diff.values()) < 2e-4
    if which == "bad_verify" and prefer_native:
        assert rt.verify_max_diff and max(rt.verify_max_diff.values()) >= 2e-4


def test_wrong_network_count_raises(built_april, tmp_path):
    c = read_container(built_april)
    path = tmp_path / "two.april"
    write_container(path, AprilContainer(
        language=c.language, name=c.name, description=c.description,
        model_type=c.model_type, params=c.params, networks=list(c.networks[:2])))
    with pytest.raises(ValueError, match="wrong network count"):
        load_model(path, device="cpu")
    with pytest.raises(ValueError, match="wrong network count"):
        j_load_model(path)


def test_inconsistent_params_raise(tmp_path, traced_april):
    """The reference's shape cross-checks (april_model.c:74-102)."""
    c = read_container(traced_april)
    path = tmp_path / "bad.april"
    write_container(path, dataclasses.replace(
        c, params=dataclasses.replace(c.params, segment_size=CFG.segment_size + 1)))
    with pytest.raises(ValueError, match="inconsistent with params"):
        load_model(path, device="cpu")
    with pytest.raises(ValueError, match="inconsistent with params"):
        j_load_model(path)


def test_interp_functions_match_jax(traced_april):
    rt = load_model(traced_april, prefer_native=False, device="cpu")
    jrt = j_load_model(traced_april, prefer_native=False)
    rng = np.random.default_rng(7)
    S, dims = 3, rt.dims
    x = rng.normal(size=(S, dims.segment_size, dims.mel)).astype(np.float32)
    h = (rng.normal(size=(dims.layers, S, dims.d_model)) * 0.1).astype(np.float32)
    c = (rng.normal(size=(dims.layers, S, dims.hidden)) * 0.1).astype(np.float32)
    ctx = rng.integers(0, dims.vocab, size=(S, dims.context)).astype(np.int32)
    with torch.no_grad():
        t_enc = rt.encoder_step(rt.weights, *(torch.from_numpy(a) for a in (x, h, c)))
        td = rt.decoder_step(rt.weights, torch.from_numpy(ctx))
        tl = rt.joiner(rt.weights, t_enc[0], td)
    j_enc = jrt.encoder_step(jrt.weights, x, h, c)
    jd = jrt.decoder_step(jrt.weights, ctx)
    jl = jrt.joiner(jrt.weights, j_enc[0], jd)
    for t, j in (*zip(t_enc, j_enc), (td, jd), (tl, jl)):
        assert tuple(t.shape) == np.asarray(j).shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)


def test_interp_precision_as_jax(traced_april, caplog):
    """The interpreter's nested weights serve as loaded: bf16 and int8 raise
    AttributeError, as the JAX package's apply_precision does (int8 after
    its warning)."""
    from april_asr_tpu.api.model import apply_precision as j_apply
    from april_asr_tpu_torch.api.model import apply_precision

    w = load_model(traced_april, prefer_native=False, device="cpu").weights
    jw = j_load_model(traced_april, prefer_native=False).weights
    assert apply_precision(w, None) is w and apply_precision(w, "f32") is w
    for prec in ("bf16", "int8"):
        with pytest.raises(AttributeError):
            j_apply(jw, prec)
        with pytest.raises(AttributeError):
            apply_precision(w, prec)
    assert "no quantizable encoder matrices" in caplog.text
