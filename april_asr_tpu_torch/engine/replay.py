"""Host-side replay of device decode events into user callbacks.

The device decode step (decode/greedy.py) emits compact event records; this
module maintains the host mirror of each session's token window and fires the
PARTIAL/FINAL/SILENCE callbacks in the reference's order (the op-bit
application order documented in decode/events.py). The mirror holds the full
token data (strings resolved from the vocabulary) so callbacks carry the same
payload as the reference handler (april_api.h:118-142).
"""

from __future__ import annotations

from typing import Callable, List

from ..decode import events as ev
from ..decode.scalar import RESULT_FINAL, RESULT_PARTIAL, RESULT_SILENCE, ScalarToken
from ..io.params import ModelParameters


class EventReplayer:
    """Mirror token window + callback dispatch for one session."""

    def __init__(
        self,
        params: ModelParameters,
        on_result: Callable[[int, List[ScalarToken]], None],
    ):
        self.params = params
        self.on_result = on_result
        self.tokens: List[ScalarToken] = []

    def apply(self, ops: int, tok: int, logprob: float, flags: int, time_ms: int, final_k: int):
        """Apply one event record, firing callbacks.

        Token lists passed to callbacks are transient views — valid only for
        the duration of the call, exactly like the reference's handler
        contract (april_api.h:176-179: the tokens pointer is owned by the
        session and reused). Sustained serving fires ~25 PARTIALs per
        session-second, so this path must not copy the window per event.
        """
        if ops == 0:
            return
        toks = self.tokens
        if ops & ev.OP_FIX_PREV_EOS and toks:
            # copy-on-write so token objects already exposed to callbacks
            # (and possibly captured) stay immutable
            t = toks[-1]
            toks[-1] = ScalarToken(
                t.token_id, t.logprob, t.flags | ev.FLAG_SENTENCE_END, t.time_ms
            )
        if ops & ev.OP_FINAL:
            self.on_result(RESULT_FINAL, toks[:final_k])
            del toks[:final_k]
        if ops & ev.OP_RESET_TOKENS:
            toks.clear()
        if ops & ev.OP_APPEND:
            toks.append(ScalarToken(int(tok), float(logprob), int(flags), int(time_ms)))
        if ops & ev.OP_PARTIAL:
            self.on_result(RESULT_PARTIAL, toks)
        if ops & ev.OP_POP:
            toks.pop()
        if ops & ev.OP_SILENCE:
            self.on_result(RESULT_SILENCE, ())
