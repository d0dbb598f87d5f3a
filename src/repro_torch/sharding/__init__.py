"""Sharding: logical-axis rules and FSDP×TP specs on DTensor (the port of
``repro.sharding``)."""
from repro_torch.sharding.api import (shard, set_mesh, get_mesh, mesh_context,
                                      logical_to_physical, RULES)
