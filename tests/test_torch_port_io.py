"""Port parity: `.april` I/O, weight carry-over, and the port's boundaries.

* A native `.april` written by the JAX `save_april` loads in the port with
  equal params, vocab tables and tensors; one written by the port reads
  back equal in the JAX package.
* `from_jax_params` carries bf16 leaves through a uint16 view, bit for bit.
* The serving precision policy matches the JAX package's: no precision
  (and no APRIL_PRECISION) serves the weights as loaded (f32), "bf16" casts
  the matrices, "int8" adds the int8 copies; every key and dtype equal, and
  f32 and bf16 models serve a Session through flush.
* The port imports neither jax nor april_asr_tpu (nor does chip_smoke.py)
  and never runs on the CPU unless asked. ONNX-form models:
  tests/test_torch_port_onnx.py.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from april_asr_tpu.io.container import read_container as j_read_container
from april_asr_tpu.io.params import build_vocab_tables as j_build_vocab_tables
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.export import make_model_parameters as j_mmp
from april_asr_tpu.models.export import save_april as j_save_april
from april_asr_tpu.testing import default_tokens
from april_asr_tpu_torch.io.container import read_container
from april_asr_tpu_torch.models import lstm_transducer as TM
from april_asr_tpu_torch.models.convert import from_jax_params, to_torch
from april_asr_tpu_torch.models.export import make_model_parameters, save_april
from april_asr_tpu_torch.models.loader import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS_KW = dict(d_model=64, hidden=96, ffn=128, joiner_dim=64, vocab=40, layers=2,
               decoder_groups=16, conv_channels=(4, 8, 8))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    dims = JM.TransducerDims(**DIMS_KW)
    params = JM.init_transducer_params(jax.random.PRNGKey(1), dims)
    path = str(tmp_path_factory.mktemp("io") / "jax_native.april")
    j_save_april(path, dims, {k: np.asarray(v) for k, v in params.items()},
                 j_mmp(dims, default_tokens(dims.vocab)), name="io-test", form="native")
    return path, dims, params


def test_jax_native_loads_in_port(jax_native):
    path, dims, params = jax_native
    rt = load_model(path, device="cpu")
    assert rt.dims == TM.TransducerDims(**DIMS_KW)
    assert rt.name == "io-test" and rt.kind == "native"
    for k, v in params.items():
        np.testing.assert_array_equal(rt.weights[k].numpy(), np.asarray(v), err_msg=k)
    jvt = j_build_vocab_tables(j_read_container(path).params)
    for f in ("word_boundary", "single_char", "end_sentence", "punctuation", "starts_digit", "is_dot"):
        np.testing.assert_array_equal(getattr(rt.vocab, f), getattr(jvt, f), err_msg=f)
    # the derived decoder table equals the JAX one (a 4-term f32 contraction)
    jt = np.asarray(JM.precompute_decoder_tables(params, dims)["dec_table"])
    np.testing.assert_allclose(rt.weights["dec_table"].numpy(), jt, atol=1e-6, rtol=1e-6)


def test_port_native_reads_back_in_jax(tmp_path):
    from april_asr_tpu.models.loader import load_model as j_load_model

    dims = TM.TransducerDims(**DIMS_KW)
    params = TM.init_transducer_params(5, dims)
    path = str(tmp_path / "port_native.april")
    save_april(path, dims, params, make_model_parameters(dims, default_tokens(dims.vocab)),
               name="port-written")
    c_port, c_jax = read_container(path), j_read_container(path)
    assert (c_jax.name, c_jax.model_type, c_jax.params.tokens) == (
        "port-written", c_port.model_type, c_port.params.tokens)
    jrt = j_load_model(path)
    assert jrt.dims == JM.TransducerDims(**DIMS_KW)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(jrt.weights[k]), v.numpy(), err_msg=k)


def test_from_jax_params_bf16_bits():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(5, 7)), jnp.bfloat16)
    a = np.asarray(x)  # ml_dtypes bfloat16
    for src in (a, a.view(np.uint16)):
        t = to_torch(src)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    out = from_jax_params({"w": a, "s": np.ones(3, np.float32), "q": np.ones(2, np.int8)})
    assert (out["w"].dtype, out["s"].dtype, out["q"].dtype) == (torch.bfloat16, torch.float32, torch.int8)


def test_no_silent_cpu(jax_native, monkeypatch):
    from april_asr_tpu_torch.api import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(jax_native[0], precision="int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(jax_native[0], device="cuda")


def _same_weights_policy(tw, jw):
    """The port's weights have the JAX runtime's keys, each in its dtype."""
    assert set(tw) == set(jw)
    for k, v in jw.items():
        assert str(tw[k].dtype) == "torch." + str(np.asarray(v).dtype), k


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_float_precisions_serve(jax_native, precision):
    """Each float precision loads with no int8 copies, matrices of its dtype
    (the JAX policy's keys and dtypes) and serves a Session through flush."""
    from april_asr_tpu.api import Model as JModel
    from april_asr_tpu_torch.api import Model, Result, Session

    m = Model(jax_native[0], precision=precision, device="cpu")
    w = m.runtime.weights
    _same_weights_policy(w, JModel(jax_native[0], precision=precision).runtime.weights)
    assert not any(k.endswith(("_q8", "_q8s")) for k in w)
    want = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    for k in ("w_ih_t", "w_hh_t", "w_hr_t", "ff1_t", "ff2_t", "enc_proj_t", "dec_proj_t", "join_t"):
        assert w[k].dtype == want, k
    got = []
    sess = Session(m, lambda r, toks: got.append(r))
    pcm = (np.random.default_rng(0).normal(0, 0.3, 9600) * 20000).astype(np.int16)
    for off in range(0, len(pcm), 3200):
        sess.feed_pcm16(pcm[off : off + 3200].tobytes())
    sess.flush()
    sess.close()
    assert Result.SILENCE in got  # the flush ran to its last phase


def test_default_precision(jax_native, monkeypatch):
    """No precision argument: APRIL_PRECISION if set, else the weights as
    loaded (f32), as the JAX Model; an explicit precision wins."""
    from april_asr_tpu.api import Model as JModel
    from april_asr_tpu_torch.api import Model

    path = jax_native[0]
    monkeypatch.delenv("APRIL_PRECISION", raising=False)
    w = Model(path, device="cpu").runtime.weights
    _same_weights_policy(w, JModel(path).runtime.weights)
    assert w["w_ih_t"].dtype == torch.float32 and "w_ih_t_q8" not in w
    for env, dtype, q8 in (("bf16", torch.bfloat16, False), ("int8", torch.bfloat16, True)):
        monkeypatch.setenv("APRIL_PRECISION", env)
        w = Model(path, device="cpu").runtime.weights
        _same_weights_policy(w, JModel(path).runtime.weights)
        assert (w["w_ih_t"].dtype, "w_ih_t_q8" in w) == (dtype, q8), env
    assert Model(path, precision="f32", device="cpu").runtime.weights["w_ih_t"].dtype == torch.float32


def test_import_guard():
    """Importing the port and every module in it pulls in neither jax nor
    april_asr_tpu; chip_smoke.py imports neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import april_asr_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'april_asr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'april_asr_tpu')]\n"
        "print(len([k for k in sys.modules if k.startswith('april_asr_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "ml_dtypes", "april_asr_tpu"}, roots
    assert "april_asr_tpu_torch" in roots
