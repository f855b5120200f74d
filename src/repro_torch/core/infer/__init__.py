from .autoguide import AutoNormal
from .diagnostics import (
    effective_sample_size,
    gelman_rubin,
    hpdi,
    print_summary,
    summary,
)
from .enum import (config_enumerate, contract_enum_factors, enum,
                   infer_discrete, markov)
from .ensemble import ChEES, ChEESState, chees_init, chees_setup
from .hmc import (HMC, NUTS, AdaptState, HMCState, hmc_init, hmc_setup,
                  nuts_init, nuts_setup)
from .hmc_util import GeneratorDraws, HostReads
from .kernel_api import (KernelSetup, SamplerKernel, collect, init_state,
                         metrics, sample)
from .mala import MALA, RWM, MRWState, mrw_setup
from .mcmc import MCMC
from .svi import SVI, SVIState, Trace_ELBO
from .util import (
    Predictive,
    constrain_fn,
    find_valid_initial_params,
    get_model_transforms,
    initialize_model,
    initialize_model_structure,
    log_density,
    log_likelihood,
    potential_energy,
    ravel,
    transform_fn,
)

__all__ = [
    "HMC", "NUTS", "AdaptState", "HMCState", "MCMC", "KernelSetup",
    "SamplerKernel", "GeneratorDraws", "HostReads", "init_state", "sample",
    "collect", "metrics", "hmc_setup", "hmc_init", "nuts_setup", "nuts_init",
    "log_density", "potential_energy", "transform_fn",
    "get_model_transforms", "ravel", "initialize_model_structure",
    "find_valid_initial_params", "effective_sample_size", "gelman_rubin",
    "hpdi", "summary", "print_summary", "config_enumerate",
    "contract_enum_factors", "enum", "infer_discrete", "markov", "ChEES",
    "ChEESState", "chees_setup", "chees_init", "MALA", "RWM", "MRWState",
    "mrw_setup", "Predictive", "constrain_fn", "initialize_model",
    "log_likelihood", "SVI", "SVIState", "Trace_ELBO", "AutoNormal",
]
