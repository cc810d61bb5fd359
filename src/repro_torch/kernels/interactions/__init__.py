from repro_torch.kernels.interactions.ops import (  # noqa: F401
    interactions_auto_edges,
    interactions_auto_traced,
    interactions_compact_edges,
    interactions_padded,
)
from repro_torch.kernels.interactions.ref import (  # noqa: F401
    interactions_dense,
    interactions_dense_traced,
)
