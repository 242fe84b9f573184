"""Batched greedy transducer decode (torch port of april_asr_tpu.decode)."""
