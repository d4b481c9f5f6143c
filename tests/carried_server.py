"""Servers of both packages on one trained DSQE.

The port's ``train_dsqe`` draws from a ``torch.Generator`` where the JAX
package draws from ``jax.random``, so the two ``build_server`` calls on one
seed train different encoders, and may decide differently (agriculture,
seed 3: 4 of the 12 held-out set ids, 2 of the paths).  A twin of a served
result therefore trains the DSQE once, in the JAX package, and carries its
parameters into the port with ``DSQE.from_numpy``; each package builds the
rest (domain, exploration table, CCA, executor) from the same seed.
"""
import numpy as np

from repro.launch.serve import build_server as jax_build_server
from repro_torch.core.cca import critical_component_analysis
from repro_torch.core.domains import build_domain, train_test_split
from repro_torch.core.dsqe import DSQE
from repro_torch.core.emulator import Emulator
from repro_torch.core.paths import PathSpace
from repro_torch.core.rps import RuntimePathSelector
from repro_torch.launch.serve import _spec
from repro_torch.runtime.server import EcoLLMServer


def port_server_with(dsqe, domain: str, *, n_queries: int, budget: float,
                     seed: int, lam: int = 0, split: bool = False,
                     use_kernel: bool = False, n_replicas: int = 2):
    """The port's ``build_server(domain, ...)`` on the CPU with the JAX
    package's trained ``dsqe`` in place of its own training.  Returns
    (server, test_idx)."""
    dom = build_domain(domain, n_queries=n_queries, seed=seed)
    space = PathSpace(spec=_spec(split, False))
    train_idx, test_idx = train_test_split(dom, 0.3)
    emu = Emulator(dom, space, seed=seed)
    table = emu.explore(train_idx, budget=budget, lam=lam)
    cca = critical_component_analysis(table, lam=lam)
    carried = DSQE.from_numpy(dsqe.params, dsqe.n_sets, device="cpu")
    rps = RuntimePathSelector(space, carried, cca, table,
                              dom.query_embeddings[train_idx], lam=lam,
                              use_kernel=use_kernel)
    server = EcoLLMServer(dom, rps, emu.exec, n_replicas=n_replicas,
                          seed=seed)
    return server, test_idx


def carried_servers(domain: str = "agriculture", *, n_queries: int = 40,
                    budget: float = 3.0, seed: int = 3, split: bool = False,
                    use_kernel: bool = False, n_replicas: int = 2):
    """The JAX package's ``build_server`` and the port's on its DSQE, with
    the same held-out ids.  Returns (jax_server, server, test_idx)."""
    jserver, jtest = jax_build_server(domain, n_queries=n_queries,
                                      budget=budget, seed=seed, split=split,
                                      use_kernel=use_kernel,
                                      n_replicas=n_replicas)
    server, test = port_server_with(jserver.rps.dsqe, domain,
                                    n_queries=n_queries, budget=budget,
                                    seed=seed, split=split,
                                    use_kernel=use_kernel,
                                    n_replicas=n_replicas)
    np.testing.assert_array_equal(test, jtest)
    return jserver, server, test
