"""The reference passes chip_smoke.py's posterior gate of the paper's
semi-supervised HMM: the JAX package's NUTS, run like the card's phase
(T = 600, T_sup = 100, K = 3, V = 10, data seed 0, the same warmup and
draws),
puts every entry of the posterior mean of ``theta`` within 4 posterior
standard deviations of the data-generating ``theta``, although it is not
within 0.1 of it: the posterior is that wide at this size."""
import numpy as np

import jax
import jax.numpy as jnp

import chip_smoke
from benchmarks.models import hmm_model as j_hmm_model
from repro.core.infer import MCMC as JMCMC
from repro.core.infer import NUTS as JNUTS
from repro_torch.bench.models import hmm_data


def test_reference_passes_the_chip_smoke_hmm_gate():
    data = hmm_data(seed=0, T=chip_smoke.HMM_T, T_sup=chip_smoke.HMM_T_SUP,
                    K=chip_smoke.HMM_K, V=chip_smoke.HMM_V)
    mcmc = JMCMC(JNUTS(j_hmm_model), num_warmup=chip_smoke.HMM_WARMUP,
                 num_samples=chip_smoke.HMM_DRAWS)
    mcmc.run(jax.random.PRNGKey(0),
             {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in data.items()})
    theta = np.asarray(mcmc.get_samples()["theta"])
    ok, err, z = chip_smoke.hmm_theta_gate(theta, data["true_theta"])
    assert ok, (err, z)
    assert err > 0.1  # a fixed 0.1 would refuse the reference itself
