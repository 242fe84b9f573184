"""Version info for april_asr_tpu_torch (the port's own copy of
april_asr_tpu/version.py).

APRIL_VERSION mirrors the reference ABI version (reference: april_api.h:54).
"""

__version__ = "0.1.0"

# Client API version expected by init(); matches the reference's APRIL_VERSION.
APRIL_VERSION = 1
