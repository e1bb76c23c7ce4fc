"""The port's LM models: the dense decoder of ``repro.models`` on torch."""

from . import layers, transformer  # noqa: F401
from .registry import input_specs, make_model  # noqa: F401
from .transformer import (Decoder, cache_from_numpy,  # noqa: F401
                          cache_to_numpy, params_from_numpy, params_to_numpy)
