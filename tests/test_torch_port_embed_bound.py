"""chip_smoke's hold on kernel 16 against its plain version (`_embed_close`,
`embed_flip_bound`), checked on the CPU without a card.

The kernel and the plain version round the same activations to bf16 after
f32 sums in other orders, so a window's outputs move when one rounding flips.
The bound is derived from the weights: one bf16 step of the largest
activation at a rounding point times the largest sum of absolute weight
paths from one activation there to one output. Here: a real flip, pushed
through the plain conv stack, stays inside it; and on synthetic [P, S, d]
pairs at chip_smoke's S = 2048 (55,296 windows) the bound passes a move of
its own size and the 0.0201 the card showed, and fails a window shift, a
missed edge window, every output scaled by 1 + 1e-3, and a NaN.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as CS
from april_asr_tpu_torch.models.lstm_transducer import TransducerDims, init_transducer_params
from april_asr_tpu_torch.ops.activations import double_swish

torch.set_num_threads(1)

P, S, D = 27, 2048, 16  # 55,296 windows, as chip_smoke holds kernel 16 at S = 2048
SEG, STEP, MEL = 9, 4, 80


def _bf(t):
    return t.to(torch.bfloat16).float()


@pytest.fixture(scope="module")
def embed():
    """Flagship-width embed weights from the flagship init (seed 0), a front
    of log-mel-like rows as chip_smoke makes them, its activations' maxima
    and the flip bound."""
    p = init_transducer_params(0, TransducerDims(layers=1, hidden=64, ffn=64, joiner_dim=64,
                                                 vocab=16))
    rng = np.random.default_rng(23)
    front = torch.from_numpy((rng.normal(size=(8, SEG, MEL)) * 2.0 - 6.0).astype(np.float32))
    amax = CS.embed_amax(p, front, 1, STEP, SEG)
    return p, front, amax, CS.embed_flip_bound(p, amax)


def _stack(p, x, flip_at=0):
    """The plain conv embed of windows x [n, seg, mel]; with flip_at = 1, 2
    or 3, the largest activation at that rounding point moved by one bf16
    step, as one flipped rounding moves it."""
    h = x[:, None]
    for L, (wk, bk, stride, pad) in enumerate((("conv1_w", "conv1_b", 1, 1),
                                               ("conv2_w", "conv2_b", 2, 0),
                                               ("conv3_w", "conv3_b", 2, 0)), 1):
        h = F.conv2d(_bf(h), _bf(p[wk]), stride=stride, padding=pad)
        h = _bf(double_swish(h + p[bk].float()[None, :, None, None]))
        if L == flip_at:
            flat = h.view(-1)
            i = int(flat.abs().argmax())
            flat[i] += float(torch.sign(flat[i])) * CS.bf16_step(float(flat[i].abs()))
    n, c, _, f = h.shape
    return h[:, :, 0, :].reshape(n, c * f) @ _bf(p["embed_out_w"]) + p["embed_out_b"].float()


def test_flip_bound_holds_one_flipped_rounding(embed):
    """A flipped rounding at each of the three points, at the largest
    activation (the step the bound takes), moves no output beyond it."""
    p, front, amax, flip = embed
    assert all(a > 0 for a in amax) and flip > 0
    base = _stack(p, front)
    moves = [float((_stack(p, front, L) - base).abs().max()) for L in (1, 2, 3)]
    assert all(0 < m <= flip for m in moves), (moves, flip)


def _pair(seed=0):
    """A want [P, S, D] at the embed's scale and a got whose windows move as
    flips move them: 40% of windows one output by up to 1e-3."""
    rng = np.random.default_rng(seed)
    want = torch.from_numpy((rng.normal(size=(P, S, D)) * 4.0).astype(np.float32))
    got = want.clone()
    moved = rng.random(P * S) < 0.4
    idx = np.flatnonzero(moved)
    delta = rng.uniform(1e-5, 1e-3, size=idx.size) * rng.choice([-1.0, 1.0], size=idx.size)
    flat = got.view(P * S, D)
    flat[idx, rng.integers(0, D, size=idx.size)] += torch.from_numpy(delta.astype(np.float32))
    return want, got


def _case(name, flip):
    want, got = _pair()
    if name == "flip":  # one window moved by the whole derived bound
        got[5, 100, 3] = want[5, 100, 3] + np.float32(flip) * 0.999
    elif name == "measured":  # the card's largest difference at S = 2048
        got[20, 2000, :] = want[20, 2000, :] + 0.0201
    elif name == "shift":
        got = torch.roll(want, 1, dims=1)
    elif name == "edge":  # the last pull of the last session left unwritten
        got[-1, -1] = 0.0
    elif name == "scale":
        got = want * (1 + 1e-3)
    elif name == "nan":
        got[0, 0, 0] = float("nan")
    return got, want


@pytest.mark.parametrize("name,holds", [("flip", True), ("measured", True), ("shift", False),
                                        ("edge", False), ("scale", False), ("nan", False)])
def test_embed_close_at_2048_sessions(embed, name, holds):
    flip = embed[3]
    got, want = _case(name, flip)
    if holds:
        err, _ = CS._embed_close(got, want, name, flip)
        assert err <= flip
    else:
        with pytest.raises(AssertionError):
            CS._embed_close(got, want, name, flip)
