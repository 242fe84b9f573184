"""Native LSTM-transducer model code (torch port of april_asr_tpu.models)."""
