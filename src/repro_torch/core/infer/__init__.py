from .diagnostics import (
    effective_sample_size,
    gelman_rubin,
    hpdi,
    print_summary,
    summary,
)
from .enum import (config_enumerate, contract_enum_factors, enum,
                   infer_discrete, markov)
from .ensemble import ChEES, chees_setup
from .hmc import HMC, NUTS, AdaptState, HMCState, hmc_setup, nuts_setup
from .hmc_util import GeneratorDraws, HostReads
from .kernel_api import KernelSetup, collect, init_state, sample
from .mala import MALA, RWM, mrw_setup
from .mcmc import MCMC
from .util import (
    find_valid_initial_params,
    get_model_transforms,
    initialize_model_structure,
    log_density,
    potential_energy,
    ravel,
    transform_fn,
)

__all__ = [
    "HMC", "NUTS", "AdaptState", "HMCState", "MCMC", "KernelSetup",
    "GeneratorDraws", "HostReads", "init_state", "sample", "collect",
    "hmc_setup", "nuts_setup", "log_density", "potential_energy",
    "transform_fn", "get_model_transforms", "ravel",
    "initialize_model_structure", "find_valid_initial_params",
    "effective_sample_size", "gelman_rubin", "hpdi", "summary",
    "print_summary", "config_enumerate", "contract_enum_factors", "enum",
    "infer_discrete", "markov", "ChEES", "chees_setup", "MALA", "RWM",
    "mrw_setup",
]
