"""Shared activation and product forms (port of
april_asr_tpu/ops/activations.py).

`sigmoid` is the tanh form `0.5*tanh(0.5x) + 0.5`, exactly as the JAX
package and its kernels compute it, so every implementation of a family
evaluates the same expression. Never `torch.sigmoid`: the two differ by ulps
in the body and qualitatively in the tails (the tanh form saturates to
exactly 0/1 beyond |x| ~ 17), and an ulp can flip an int8 rounding decision
downstream. The CUDA kernels spell the same expression with `tanhf`.
"""

from __future__ import annotations

import torch


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """logistic(x) as 0.5*tanh(0.5x)+0.5."""
    return 0.5 * torch.tanh(0.5 * x) + 0.5


def double_swish(x: torch.Tensor) -> torch.Tensor:
    """icefall DoubleSwish: x * sigmoid(x - 1), with the tanh-form sigmoid."""
    return x * sigmoid(x - 1.0)


def dot_wd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as `jnp.dot(x.astype(w.dtype), w, preferred_element_type=f32)`:
    x rounded to w's dtype first, f32 accumulation. A bf16 weight sees a
    bf16-rounded operand; an f32 weight an f32 product."""
    return x.to(w.dtype).float() @ w.float()
