"""Device-mesh construction for the decision/scan runtime.

The reference's only distribution story is ssh/scp/qsub between hosts
(SURVEY.md §5.8); here the runtime is a jax.sharding.Mesh: ``dp`` for read
batches, ``ep`` for index hash shards, ``sp`` for contig-sharded scans.
The collectives are XLA-inserted (NCCL between GPUs), never hand-rolled
transports.
"""

from typing import Dict, Optional

import numpy as np


def make_mesh(axes: Dict[str, int], devices=None):
    """Build a Mesh with named axes from `axes` (e.g. {"dp": 2, "ep": 4}).
    Total must not exceed available devices; axes sized -1 absorb the rest."""
    import jax
    from jax.sharding import Mesh
    devices = list(devices if devices is not None else jax.devices())
    names = list(axes)
    sizes = [axes[n] for n in names]
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    known = int(np.prod([s for s in sizes if s != -1]))
    if unknown:
        assert len(unknown) == 1
        sizes[unknown[0]] = len(devices) // known
    total = int(np.prod(sizes))
    assert total <= len(devices), (sizes, len(devices))
    grid = np.array(devices[:total]).reshape(sizes)
    return Mesh(grid, tuple(names))


def decision_mesh(n_dp: Optional[int] = None, n_ep: Optional[int] = None,
                  devices=None):
    """Default livefish mesh: ep gets a small power of two, dp the rest."""
    import jax
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_ep is None:
        n_ep = 1
        while n_ep * 2 <= min(n, 8) and n % (n_ep * 2) == 0:
            n_ep *= 2
    if n_dp is None:
        n_dp = n // n_ep
    return make_mesh({"dp": n_dp, "ep": n_ep}, devices=devices[:n_dp * n_ep])
