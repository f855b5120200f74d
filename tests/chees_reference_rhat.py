"""Split R-hat of the JAX package's ChEES at ``chip_smoke.py``'s setting.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/chees_reference_rhat.py \
        --draws 300 --seed 0

Runs the reference ``MCMC(ChEES(logreg_model), 300, draws, num_chains=8)``
on the 581,012 x 54 CoverType-shaped data of ``chip_smoke.py``
(``covtype_data(seed=0)``) on the CPU and prints one JSON line: the largest
split R-hat and the smallest ESS over the 54 coefficients, and the means of
the learned trajectory length, ``num_steps``, step size and accept
probability over the draws.  It measures whether ``chip_smoke.py``'s ChEES
gate (split R-hat < 1.01) holds for the reference itself at a given number
of draws; one run at full size takes about 14 minutes on 8 CPU cores.  Not
a test (pytest does not collect it): it imports both packages, as the
tests do.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

import repro._compat
from benchmarks.models import logreg_model
from repro.core.infer import MCMC, ChEES, effective_sample_size, gelman_rubin
from repro_torch.bench.models import covtype_data


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=581_012)
    parser.add_argument("--warmup", type=int, default=300)
    parser.add_argument("--draws", type=int, default=300)
    parser.add_argument("--chains", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    # the reference's shared_draw breaks on jax 0.9.0 (ROADMAP preamble)
    repro._compat.ensure_optimization_barrier_batch_rule = lambda: None
    data = covtype_data(seed=0, n=args.n, d=54)
    mcmc = MCMC(ChEES(logreg_model), num_warmup=args.warmup,
                num_samples=args.draws, num_chains=args.chains)
    mcmc.run(jax.random.PRNGKey(args.seed), jnp.asarray(data["x"]),
             y=jnp.asarray(data["y"]))
    w = np.asarray(mcmc.get_samples(group_by_chain=True)["w"])
    extra = mcmc.get_extra_fields(group_by_chain=True)
    print(json.dumps({
        **vars(args),
        "max_split_rhat": float(np.max(gelman_rubin(w))),
        "min_ess": float(np.min(effective_sample_size(w))),
        **{key: float(np.mean(np.asarray(extra[key]))) for key in
           ("trajectory_length", "num_steps", "step_size", "accept_prob")}}))


if __name__ == "__main__":
    main()
