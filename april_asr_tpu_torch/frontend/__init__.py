"""Streaming log-mel frontend (torch port of april_asr_tpu.frontend)."""
