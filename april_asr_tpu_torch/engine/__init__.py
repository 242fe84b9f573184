"""Batched streaming engine (torch port of april_asr_tpu.engine)."""
