"""Multi-device parallelism: path-sharded Monte Carlo and LSM over a
``torch.distributed`` device mesh (``sharding.py``), and the multi-rank dry
run (``dryrun.py``)."""

from .sharding import (
    make_multislice_mesh,
    make_paths_mesh,
    sharded_lsm_price,
    sharded_lsm_price_fn,
    sharded_mc_price,
    sharded_mc_price_fn,
    sharded_mc_price_multislice_fn,
    sharded_surface_fn,
)

__all__ = [
    "make_paths_mesh",
    "make_multislice_mesh",
    "sharded_mc_price",
    "sharded_mc_price_fn",
    "sharded_mc_price_multislice_fn",
    "sharded_lsm_price",
    "sharded_lsm_price_fn",
    "sharded_surface_fn",
]
