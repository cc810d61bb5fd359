from repro_torch.kernels.interactions.ops import (  # noqa: F401
    interactions_compact_edges,
)
from repro_torch.kernels.interactions.ref import interactions_dense  # noqa: F401
