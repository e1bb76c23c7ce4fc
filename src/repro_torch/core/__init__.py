"""The port's probabilistic-programming layer: DSL -> Bayesian network ->
compiled VMP program -> full-batch VMP, SVI or Gibbs sampling on one
device, behind ``make_engine("vmp")``, ``make_engine("svi")`` and
``make_engine("gibbs")``."""

from .dsl import Model, ModelBuilder, build  # noqa: F401
from .network import BayesianNetwork, CategoricalRV, DirichletRV, Plate  # noqa: F401
from .compiler import VMPProgram, compile_program, slice_arrays, sliced_shadow  # noqa: F401
from .vmp import (VMPState, full_elbo, init_state, latent_responsibilities,  # noqa: F401
                  state_from_numpy, state_to_numpy)
from .runtime import make_step, run_inference  # noqa: F401
from .engine import EngineConfig, InferenceEngine, InferenceResult, make_engine  # noqa: F401
from .metrics import aligned_tv  # noqa: F401
from .svi import SVI, SVIConfig  # noqa: F401
from . import models  # noqa: F401
