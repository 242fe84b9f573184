"""Port parity: tensor-parallel serving (kernels 18-21, the TP stack and the
TP engine over torch.distributed), at the JAX TP test's dims
(tests/test_tp_shard_map.py:37-42: d 128, hidden 256, ffn 256, 2 layers,
vocab 128, S = 128) and model_parallel m = 2.

* Kernels: the plain versions of 18-21 against the JAX kernels in interpret
  mode on one shard's gate-shuffled slices (block_s = S). f32 to atol = rtol
  = 2e-5 (JAX's TP layer bound), int8 to 1e-5, bf16 weights to the bound
  test_torch_port_perpull.py holds kernel 12 to at bf16 (atol 2e-2, rtol
  1e-3: an ulp upstream can flip the bf16 rounding of an activation).
* Weights: the gate shuffle and its permutation element-exact against the
  JAX package's, every key of `_GATE_KEYS`, m = 2 and 4; the rank slices
  of `prepare_tp_weights` concatenate back to the shuffled whole.
* Stack and engine: the port runs in two rank processes (gloo, one launch
  for the module, started before the first test so that the JAX side runs
  meanwhile). `_lstm_stack_step_tp` against the JAX one under shard_map on
  the (1, 2) mesh of forced host devices, f32 and int8, gated and ungated,
  at the JAX test's bounds (2e-5 f32, 1e-5 int8), and against the port's
  single-device `_lstm_stack_step`. The TP engine, 2 steps and a flush:
  at f32 against the JAX TP engine with APRIL_PALLAS=1 (its kernels in
  interpret mode), element-exact up to a near-tie parting, as
  test_torch_port_engine.py holds the port's f32 stream; at int8 against
  the port's single-device int8 engine, at least 80% of sessions identical
  (the JAX TP test's criterion) and every parting a near tie; both ranks'
  event blobs identical. The stack also at d 66 / hidden 130 / ffn 198
  (`ODD`: shards of 65 hidden units and 99 ffn columns, not multiples of 4),
  which the port runs on its kernels' widths zero-padded (the JAX package
  on XLA), at the same bounds.
* Refusals: a mesh with a data axis, and widths m does not divide.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

from april_asr_tpu.api import Model as JModel
from april_asr_tpu.config import EngineConfig as JEngineConfig
from april_asr_tpu.engine.batch import BatchEngine as JBatchEngine
from april_asr_tpu.engine.step import unpack_events_np as j_unpack
from april_asr_tpu.models import lstm_transducer as JM
from april_asr_tpu.models.export import make_model_parameters as j_mmp
from april_asr_tpu.models.export import save_april as j_save_april
from april_asr_tpu.ops import lstm_tp_pallas as JTP
from april_asr_tpu.parallel import tp as JTPW
from april_asr_tpu.testing import default_tokens
from april_asr_tpu_torch.models.convert import from_jax_params
from april_asr_tpu_torch.ops import lstm_tp_kernels as TK
from april_asr_tpu_torch.parallel import tp as TPW
from april_asr_tpu_torch.parallel.mesh import TPMesh
from april_asr_tpu_torch.testing import (
    INT_DECODE, RankGroup, capture_events, check_parting, engine_run)

DIMS = JM.TransducerDims(
    mel=80, segment_size=9, segment_step=4, d_model=128, hidden=256, ffn=256,
    joiner_dim=128, vocab=128, layers=2, context=2, decoder_groups=32,
    conv_channels=(4, 8, 8),
)
S, M, TICKS, CHUNK = 128, 2, 2, 3200
F32_TOL = dict(atol=2e-5, rtol=2e-5)
I8_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=1e-3)
ODD = dataclasses.replace(DIMS, d_model=66, hidden=130, ffn=198)
# (int8, gated, at ODD's widths)
STACK_CASES = ([(q, gated, False) for q in (False, True) for gated in (False, True)]
               + [(False, True, True), (True, True, True)])


def _np_params(p):
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def jparams():
    p = JM.init_transducer_params(jax.random.PRNGKey(0), DIMS)
    p["join_b"] = p["join_b"].at[0].add(1.5)  # sparse emissions
    return JM.precompute_decoder_tables(p, DIMS)


@pytest.fixture(scope="module")
def qparams(jparams):
    return JM.quantize_weights(jparams)


@pytest.fixture(scope="module")
def odd_params():
    """The layer leaves at ODD's widths: (f32, int8)."""
    p = JM.init_transducer_params(jax.random.PRNGKey(1), ODD)
    return p, JM.quantize_weights(p)


def _stack_params(q, odd, jparams, qparams, odd_params):
    if odd:
        return odd_params[int(q)]
    return qparams if q else jparams


def _stack_inputs(seed, dims=DIMS):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, dims.d_model)).astype(np.float32)
    h = (rng.normal(size=(dims.layers, S, dims.d_model)) * 0.1).astype(np.float32)
    c = (rng.normal(size=(dims.layers, S, dims.hidden)) * 0.1).astype(np.float32)
    gate = rng.random(S) < 0.5
    return x, h, c, gate


def _audio():
    rng = np.random.default_rng(5)
    return (rng.normal(0, 0.2, size=(TICKS, S, CHUNK)) * 20000).astype(np.int16)


@pytest.fixture(scope="module")
def april(jparams, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp") / "tp.april")
    p = {k: v for k, v in _np_params(jparams).items() if k != "dec_table"}
    j_save_april(path, DIMS, p, j_mmp(DIMS, default_tokens(DIMS.vocab)), name="tp", form="native")
    return path


@pytest.fixture(scope="module", autouse=True)
def ranks(jparams, qparams, odd_params, april):
    """Every port-side case in one pair of rank processes, started before
    the module's first test; `rank_results` joins them."""
    cases = []
    for q, gated, odd in STACK_CASES:
        x, h, c, gate = _stack_inputs(4, ODD if odd else DIMS)
        cases.append(dict(kind="stack", m=M, x=x, h=h, c=c, gate=gate if gated else None,
                          params=_np_params(_stack_params(q, odd, jparams, qparams, odd_params))))
    audio = _audio()
    for prec in (None, "int8"):
        cases.append(dict(kind="engine", path=april, precision=prec, m=M, device="cpu",
                          audio=audio, ticks=TICKS, margins=True))
    cases.append(dict(kind="mesh", m=1))
    group = RankGroup("april_asr_tpu_torch.testing:tp_cases", {"cases": cases}, world=M,
                      timeout=150)
    box = {}

    def results():
        if "out" not in box:
            box["out"] = group.join()
        return box["out"]

    yield results
    if "out" not in box:
        try:
            results()
        except (RuntimeError, TimeoutError):
            pass  # the tests that read the results report it


@pytest.fixture(scope="module")
def rank_results(ranks):
    return ranks()


def _shard(params, k):
    """Shard k's slices (m = M) of the JAX-shuffled layer-0 encoder weights."""
    sh = JTPW.shuffle_gate_columns(params, M)
    out = {}
    for name, spec in JTPW.tp_param_specs(sh).items():
        if name not in JTPW._TP_SPECS:
            continue
        w = np.asarray(sh[name])
        axis = next((i for i, e in enumerate(spec) if e == "model"), None)
        if axis is not None:
            n = w.shape[axis] // M
            w = np.take(w, np.arange(k * n, (k + 1) * n), axis=axis)
        out[name] = w[0]
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cast(params, prec):
    if prec == "bf16":
        return JM.cast_weights(params, jnp.bfloat16)
    return params


def _kernel_inputs(seed):
    rng = np.random.default_rng(seed)
    d, Hs = DIMS.d_model, DIMS.hidden // M
    x = rng.normal(size=(S, d)).astype(np.float32)
    h = (rng.normal(size=(S, d)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(S, Hs)) * 0.3).astype(np.float32)
    gate = rng.random(S) < 0.5
    return x, h, c, gate


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_gate_cell_proj_matches_jax(jparams, prec):
    """Kernel 18 on shard 1 of the f32 or bf16 weights, gated and ungated."""
    w = _shard(_cast(jparams, prec), 1)
    x, h, c, gate = _kernel_inputs(1)
    tol = F32_TOL if prec == "f32" else BF16_TOL
    for g in (None, gate):
        want = JTP.lstm_gate_cell_proj(
            jnp.asarray(x), jnp.asarray(h), jnp.asarray(c), w["w_ih_t"], w["w_hh_t"], w["bias"],
            w["w_hr_t"], None if g is None else jnp.asarray(g), block_s=S, interpret=True)
        tw = from_jax_params({k: w[k] for k in ("w_ih_t", "w_hh_t", "bias", "w_hr_t")})
        got = TK.lstm_gate_cell_proj(_t(x), _t(h), _t(c), tw["w_ih_t"], tw["w_hh_t"], tw["bias"],
                                     tw["w_hr_t"], None if g is None else _t(g))
        for gv, wv in zip(got, want):
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **tol)


def test_gates_cell_i8_matches_jax(qparams):
    """Kernel 19 on shard 1 of the int8 weights, gated and ungated."""
    w = _shard(qparams, 1)
    x, h, c, gate = _kernel_inputs(2)
    keys = ("w_ih_t_q8", "w_ih_t_q8s", "w_hh_t_q8", "w_hh_t_q8s", "bias")
    tw = from_jax_params({k: w[k] for k in keys})
    for g in (None, gate):
        want = JTP.lstm_gates_cell_i8(
            jnp.asarray(x), jnp.asarray(h), jnp.asarray(c), *(w[k] for k in keys),
            None if g is None else jnp.asarray(g), block_s=S, interpret=True)
        got = TK.lstm_gates_cell_i8(_t(x), _t(h), _t(c), *(tw[k] for k in keys),
                                    None if g is None else _t(g))
        for gv, wv in zip(got, want):
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **I8_TOL)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_ffn_partial_matches_jax(jparams, prec):
    """Kernel 20 on shard 1 of the f32 or bf16 weights."""
    w = _shard(_cast(jparams, prec), 1)
    y = _kernel_inputs(3)[0]
    want = JTP.ffn_partial(jnp.asarray(y), w["ff1_t"], w["ff1_b"], w["ff2_t"], block_s=S,
                           interpret=True)
    tw = from_jax_params({k: w[k] for k in ("ff1_t", "ff1_b", "ff2_t")})
    got = TK.ffn_partial(_t(y), tw["ff1_t"], tw["ff1_b"], tw["ff2_t"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(F32_TOL if prec == "f32" else BF16_TOL))


def test_ffn_mid_i8_matches_jax(qparams):
    """Kernel 21 on shard 1 of the int8 weights."""
    w = _shard(qparams, 1)
    y = _kernel_inputs(4)[0]
    keys = ("ff1_t_q8", "ff1_t_q8s", "ff1_b")
    want = JTP.ffn_mid_i8(jnp.asarray(y), *(w[k] for k in keys), block_s=S, interpret=True)
    tw = from_jax_params({k: w[k] for k in keys})
    got = TK.ffn_mid_i8(_t(y), *(tw[k] for k in keys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **I8_TOL)


def test_rowq8_global_matches_jax():
    """rowq8_global without a model group is _rowq8 of the whole row: the
    same int8 values and scales as the JAX function on one shard."""
    x = np.random.default_rng(6).normal(size=(S, 64)).astype(np.float32)
    jq, js = jax.jit(jax.vmap(lambda r: JTP.rowq8_global(r, "m"), axis_name="m"))(x[None])
    q, s = TK.rowq8_global(_t(x), None)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq[0]).astype(np.float32))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js[0]))


@pytest.mark.parametrize("m", [2, 4])
def test_gate_shuffle_matches_jax(qparams, m):
    np.testing.assert_array_equal(TPW.gate_shuffle_perm(DIMS.hidden, m),
                                  JTPW.gate_shuffle_perm(DIMS.hidden, m))
    tp = from_jax_params(_np_params(qparams))
    got = TPW.shuffle_gate_columns(tp, m)
    want = JTPW.shuffle_gate_columns(qparams, m)
    for k in JTPW._GATE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in set(tp) - set(JTPW._GATE_KEYS):
        assert got[k] is tp[k]


def test_prepare_tp_weights_slices(qparams):
    """The rank slices concatenate back to the shuffled whole along the JAX
    spec's model axis; replicated weights are whole on every rank."""
    tp = from_jax_params(_np_params(qparams))
    shuffled = TPW.shuffle_gate_columns(tp, M)
    specs = TPW.tp_param_specs(shuffled)
    for k, spec in JTPW.tp_param_specs(qparams).items():
        assert specs[k] == next((i for i, e in enumerate(spec) if e == "model"), None), k
    ranks = [TPW.prepare_tp_weights(tp, TPMesh(group=None, rank=r, model_parallel=M))
             for r in range(M)]
    for k, axis in specs.items():
        if axis is None:
            assert all(torch.equal(r[k], shuffled[k]) for r in ranks), k
        else:
            assert torch.equal(torch.cat([r[k] for r in ranks], dim=axis), shuffled[k]), k


def _jax_stack(params, x, h, c, gate):
    try:
        from jax import shard_map as shard_map_fn
    except ImportError:
        from jax.experimental.shard_map import shard_map as shard_map_fn

    mesh = Mesh(np.array(jax.devices()[:M]).reshape(1, M), ("data", "model"))
    shuffled = JTPW.shuffle_gate_columns(params, M)
    specs = JTPW.tp_param_specs(shuffled)
    gated = gate is not None

    def body(w, x, h, c, *g):
        return JM._lstm_stack_step_tp(w, x, h, c, "model", g[0] if gated else None)

    ins = (JP("data"), JP(None, "data"), JP(None, "data", "model")) + ((JP("data"),) if gated else ())
    args = (jnp.asarray(x), jnp.asarray(h), jnp.asarray(c)) + ((jnp.asarray(gate),) if gated else ())
    out = jax.jit(shard_map_fn(body, mesh=mesh, in_specs=(specs,) + ins,
                               out_specs=(JP("data"), JP(None, "data"), JP(None, "data", "model")),
                               check_vma=False))(shuffled, *args)
    return [np.asarray(v) for v in out]


@pytest.mark.parametrize("case", range(len(STACK_CASES)),
                         ids=[f"{'int8' if q else 'f32'}-{'gated' if g else 'ungated'}"
                              f"{'-odd' if odd else ''}" for q, g, odd in STACK_CASES])
def test_tp_stack_matches_jax_and_single(jparams, qparams, odd_params, rank_results, case):
    q, gated, odd = STACK_CASES[case]
    x, h, c, gate = _stack_inputs(4, ODD if odd else DIMS)
    want = _jax_stack(_stack_params(q, odd, jparams, qparams, odd_params), x, h, c,
                      gate if gated else None)
    tol = I8_TOL if q else F32_TOL
    outs = [r[case] for r in rank_results]
    y, h2, _ = outs[0]["tp"]
    c2 = np.concatenate([o["tp"][2] for o in outs], axis=2)
    for r in outs[1:]:
        np.testing.assert_array_equal(r["tp"][0], y)
        np.testing.assert_array_equal(r["tp"][1], h2)
    for got, jw, single, name in zip((y, h2, c2), want, outs[0]["single"], "yhc"):
        np.testing.assert_allclose(got, jw, **tol, err_msg=f"{name} vs JAX")
        np.testing.assert_allclose(got, single, **tol, err_msg=f"{name} vs single device")


def _ranks_agree(outs):
    for r in outs[1:]:
        assert len(r["blobs"]) == len(outs[0]["blobs"]) == TICKS + 1
        for a, b in zip(outs[0]["blobs"], r["blobs"]):
            np.testing.assert_array_equal(a, b)


def _engine(rank_results, prec):
    outs = [r[len(STACK_CASES) + (prec == "int8")] for r in rank_results]
    _ranks_agree(outs)
    assert outs[0]["c_shape"] == (DIMS.layers, S, DIMS.hidden // M)
    return outs[0]


def test_tp_engine_f32_matches_jax_tp_engine(april, rank_results, monkeypatch):
    """The JAX TP BatchEngine (kernels 18 and 20 in interpret mode) and the
    port's, 2 steps and a flush: events, callbacks and integer decode state
    equal up to a near-tie parting."""
    monkeypatch.setenv("APRIL_PALLAS", "1")
    rt = JModel(april).runtime
    mesh = Mesh(np.array(jax.devices()[:M]).reshape(1, M), ("data", "model"))
    je = JBatchEngine(rt, batch=S, cfg=JEngineConfig(chunk_samples=CHUNK), mesh=mesh)
    assert je.prog.tp_axes == ("model",)
    jev, jrec, jdec = [], [[] for _ in range(S)], []
    capture_events(je.prog, j_unpack, jev)
    for i in range(S):
        je.alloc(lambda r, toks, i=i: jrec[i].append(
            (int(r), tuple((int(t.token_id), int(t.time_ms)) for t in toks))))
    audio = _audio()
    recs = []
    for k in range(TICKS + 1):
        if k < TICKS:
            for i in range(S):
                je.feed(i, audio[k, i])
            je.tick()
        else:
            je.flush(np.ones(S, bool))
        recs.append([list(r) for r in jrec])
        jdec.append({key: np.asarray(je.state["decode"][key]) for key in INT_DECODE})
    tp = _engine(rank_results, None)
    parted = {}
    for k in range(TICKS + 1):
        check_parting(k, jev[k], tp["events"][k], tp["cells"][k], recs[k], tp["recs"][k],
                      jdec[k], tp["dec"][k], parted)
    assert sum(len(r) for r in jrec) > S
    print(f"f32 TP engine vs JAX: parted at near-ties (step, cell, margin): {parted}")


def test_tp_engine_int8_matches_single_device(april, rank_results):
    """The port's TP int8 engine against its single-device int8 engine."""
    args = dict(path=april, precision="int8", m=1, device="cpu", audio=_audio(), ticks=TICKS,
                margins=True)
    single = engine_run(args)
    tp = _engine(rank_results, "int8")
    parted = {}
    for k in range(TICKS + 1):
        check_parting(k, single["events"][k], tp["events"][k], single["cells"][k],
                      single["recs"][k], tp["recs"][k], single["dec"][k], tp["dec"][k], parted)
    assert S - len(parted) >= int(0.8 * S), f"only {S - len(parted)}/{S} sessions identical"
    assert sum(len(r) for r in single["recs"][-1]) > S
    print(f"int8 TP engine vs single device: parted at near-ties: {parted}")


def test_mesh_refuses_data_axis(rank_results):
    for r in rank_results:
        kind, msg = r[-1]
        assert kind == "NotImplementedError" and "ROADMAP queue 1 item 9" in msg


def test_build_engine_refuses_indivisible_widths(april):
    """hidden 256 and ffn 256 do not divide by 3: no TP program, and no
    silent single-device one."""
    from april_asr_tpu_torch.api import Model
    from april_asr_tpu_torch.engine.step import build_engine

    rt = Model(april, device="cpu").runtime
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        build_engine(rt, 4, mesh=TPMesh(group=None, rank=0, model_parallel=3))


def test_rank_group_reports_a_failing_rank():
    """A rank that raises ends the group at once with its output, instead of
    leaving the others waiting in a collective until the time limit."""
    group = RankGroup("april_asr_tpu_torch.testing:tp_cases",
                      {"cases": [dict(kind="stack", m=M, params={})]}, world=M, timeout=60)
    with pytest.raises(RuntimeError, match="KeyError"):
        group.join()
