"""``repro_torch.sharding``: the reference's sharding rules and activation
constraints on ``torch.distributed`` ``DeviceMesh``/DTensor."""
from repro_torch.sharding.api import (  # noqa: F401
    constrain,
    mesh_context,
    set_mesh,
)
from repro_torch.sharding.rules import (  # noqa: F401
    input_specs_sharding,
    param_specs,
    placements,
)
