"""The port's probabilistic-programming layer: DSL -> Bayesian network ->
compiled VMP program -> full-batch VMP on one device."""

from .dsl import Model, ModelBuilder, build  # noqa: F401
from .network import BayesianNetwork, CategoricalRV, DirichletRV, Plate  # noqa: F401
from .compiler import VMPProgram, compile_program  # noqa: F401
from .vmp import (VMPState, full_elbo, init_state, latent_responsibilities,  # noqa: F401
                  state_from_numpy, state_to_numpy)
from .runtime import make_step, run_inference  # noqa: F401
from .metrics import aligned_tv  # noqa: F401
from . import models  # noqa: F401
