from .binio import BinaryFormatError
from .container import (
    MODEL_LSTM_TRANSDUCER_STATELESS,
    MODEL_NATIVE_TRANSDUCER_TPU,
    AprilContainer,
    read_container,
    write_container,
)
from .params import ModelParameters, VocabTables, build_vocab_tables, read_params, write_params

__all__ = [
    "BinaryFormatError",
    "AprilContainer",
    "read_container",
    "write_container",
    "ModelParameters",
    "VocabTables",
    "build_vocab_tables",
    "read_params",
    "write_params",
    "MODEL_LSTM_TRANSDUCER_STATELESS",
    "MODEL_NATIVE_TRANSDUCER_TPU",
]
