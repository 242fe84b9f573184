"""Device -> host event records for decode results.

The reference invokes the user handler synchronously from inside the decode
loop (src/april_session.c:285-291, :199-211). On TPU the decode loop runs
batched inside one jitted step, so handler-visible actions are recorded as
compact per-inner-step event records; the host replays them against a mirror
token list and fires the callbacks (engine/host.py). Op bits are applied in
the fixed order below, which reproduces the reference's call order within one
aas_process_logits invocation.
"""

# Order of application (host replay): FIX_PREV_EOS, FINAL(k), RESET_TOKENS,
# APPEND, PARTIAL, POP, SILENCE.
OP_FIX_PREV_EOS = 1  # set SENTENCE_END on the previous token (april_session.c:380-382)
OP_FINAL = 2  # FINAL callback with tokens[:k]; keep tokens[k:] (:199-254)
OP_RESET_TOKENS = 4  # drop all tokens, no callback ("no room left", :392-396)
OP_APPEND = 8  # append the record's token (:278)
OP_PARTIAL = 16  # PARTIAL callback with current tokens (:285-291)
OP_POP = 32  # pop last token (provisional confident-blank emit, :419-421)
OP_SILENCE = 64  # SILENCE callback (:257-268)

# Token flag bits (mirror AprilTokenFlagBits, april_api.h:108-116)
FLAG_WORD_BOUNDARY = 1
FLAG_SENTENCE_END = 2

EVENT_FIELDS = ("ops", "tok", "logprob", "flags", "time_ms", "final_k")
