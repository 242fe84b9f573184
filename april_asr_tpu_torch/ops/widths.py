"""Widths the hand-written kernels take, and zero padding up to them.

Every encoder layer kernel reads rows in 16-byte (f32), 8-byte (bf16) or
4-byte (int8) pieces, so it takes d_model, hidden and ffn that are multiples
of `ALIGN`; kernel 16 (csrc/conv_embed_tile.cu, conv_embed.cu) takes conv channels 2 and 3 that
are multiples of 8 and an even d_model. A model at other widths runs the same
kernels on copies of its weights zero-padded to those multiples
(models/lstm_transducer.py `padded_layers`, ops/conv_embed_kernels.py
`embed_weight_forms`), with its activations and state padded likewise:

* a zero weight row adds exact zeros to every dot, and a zero weight column
  and bias give a zero output column;
* the padded columns stay zero through a layer: a padded hidden unit's gates
  are 0, so its cell keeps c = 0 and its h is 0; DoubleSwish(0) = 0; the int8
  row scales take the largest |value| of a row, which zeros do not move;
* only BasicNorm's mean reads the width: the kernels take the model's d_model
  for it (`norm_d`), so the padded layer computes the model's layer and its
  padded columns come out zero.

The JAX package takes XLA at such widths (april_asr_tpu/ops/lstm_pallas.py
`supported_dims`); the port serves them on its kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch

ALIGN = 4  # the layer kernels' width multiple


def round_up(n: int, m: int = ALIGN) -> int:
    return -(-n // m) * m


def zero_pad(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`t` zero-padded at the end of each axis to `shape` (`t` itself where
    the shapes are equal)."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out
