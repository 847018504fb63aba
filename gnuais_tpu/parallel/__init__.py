"""Distribution layer: device meshes, stream sharding (data parallel),
time-block sharding with overlap-save halo exchange (sequence parallel),
and the multi-host streaming topology.

The reference is single-node C with two pthread-free receivers
(SURVEY.md section 2c); here independent capture streams shard across
devices via ``NamedSharding``/``shard_map`` on a ``streams`` mesh axis,
and long single streams shard across time with FIR halos exchanged via
``ppermute`` and decoder carry state handed along the time axis.
"""

from gnuais_tpu.parallel import mesh  # noqa: F401
