"""The int8 chunk stack on the wavefront schedule (kernel 15) against the
shipped layer-major stack (kernel 2, then kernel 3, per layer), on one card.

Port of tools/profile_wavefront.py: the 12-layer flagship int8 stack as
wavefront slabs of 6, 4 and 12 layers (`stack_wavefront_i8`). A 6-layer
slab's int8 weights (40.9 MB) fit the H100's 50 MB L2; a 12-layer slab's
(81.8 MB) do not. Timing and the reported differences as
`profile_chunk_split` (CUDA events, median of `--reps` stacks; y/h/c max
differences from the shipped stack); the JAX tool's block_s sweep has no
counterpart (the kernel's session tile is fixed).

    python -m april_asr_tpu_torch.tools.profile_wavefront [--S 2048] [--P 25]
        [--reps 5] [--device cuda] [--tiny]
"""

from __future__ import annotations

import functools

from ..ops.lstm_wavefront_kernels import stack_wavefront_i8
from .profile_chunk_split import compare, parse

VARIANTS = {f"wavefront-{n}": functools.partial(stack_wavefront_i8, slab=n)
            for n in (6, 4, 12)}


def main(argv=None) -> dict:
    args, stack_args = parse(argv, 2048, 25, __doc__)
    return compare(VARIANTS, stack_args, args.reps, "profile_wavefront")


if __name__ == "__main__":
    main()
